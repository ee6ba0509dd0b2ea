"""The assigned (architecture x input-shape) grid: 10 archs x 4 cells.

``decode_*`` / ``long_*`` are serve steps (one token against a full KV
cache), not train steps.  ``long_500k`` needs sub-quadratic attention;
the pure full-attention archs skip it, with the reason.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.config import ModelConfig

__all__ = ["CELLS", "Cell", "applicable", "grid"]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One input shape: its step kind, sequence and global batch."""

    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


CELLS = {
    "train_4k": Cell("train_4k", "train", 4_096, 256),
    "prefill_32k": Cell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Cell("decode_32k", "decode", 32_768, 128),
    "long_500k": Cell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, cell: Cell) -> Tuple[bool, Optional[str]]:
    """(whether ``cfg`` runs ``cell``, the reason when it does not)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention: 500k decode would need a "
                       "sub-quadratic mechanism this arch lacks (DESIGN.md §5)")
    return True, None


def grid():
    """Every (arch name, cell) pair, archs sorted."""
    from ..configs import ARCHS
    for arch in sorted(ARCHS):
        for cell in CELLS.values():
            yield arch, cell
