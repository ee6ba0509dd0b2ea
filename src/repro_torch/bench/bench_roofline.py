"""Paper Fig. 2: the two-ceiling roofline with every studied kernel placed
on each platform of ``PLATFORMS`` (the H100 parts included).  `derived`
carries (intensity, attainable under each engine ceiling, bound-class)
-- the CSV equivalent of the figure."""
from __future__ import annotations

from ..core import PLATFORMS, paper_table, place
from .common import emit


def rows():
    """One CSV row per (platform, paper kernel)."""
    out = []
    for key, hw in PLATFORMS.items():
        dsize = 8 if key != "v5e" else 4
        for traits in paper_table(dsize):
            pt = place(traits.name, traits.intensity, hw)
            bound = "memory" if pt.memory_bound_vector else "compute"
            out.append({
                "name": f"roofline/{key}/{traits.name}",
                "us_per_call": "",
                "derived": (f"I={pt.intensity:.4f};"
                            f"P_vec={pt.attainable_vector/1e12:.2f}TF;"
                            f"P_mat={pt.attainable_matrix/1e12:.2f}TF;"
                            f"{bound}-bound"),
            })
    return out


def main():
    emit(rows())


if __name__ == "__main__":
    main()
