"""Engine-aware hardware specifications.

The paper (Table 1) characterizes each platform by peak throughput *per
execution engine* (CUDA core vs tensor core) plus memory bandwidth.  The
port keeps the reference's platforms and adds the H100 parts it runs on:

    CUDA core  -> vector engine
    tensor core-> matrix engine

All throughputs are in FLOP/s, bandwidths in B/s.  The H100 numbers are
NVIDIA datasheet peaks (FP64, Table-1 style), not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Engine:
    """One execution engine (matrix or vector) at a given precision."""

    name: str
    peak_flops: float  # FLOP/s
    dtype: str


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """A platform: engines sharing one memory hierarchy (paper Fig. 1)."""

    name: str
    mem_bw: float                      # HBM bandwidth, B/s
    engines: Dict[str, Engine]         # keyed by "vector"/"matrix"
    l2_bytes: Optional[int] = None     # last-level on-chip cache
    link_bw: Optional[float] = None    # per-link interconnect, B/s
    chips: int = 1

    @property
    def vector(self) -> Engine:
        return self.engines["vector"]

    @property
    def matrix(self) -> Engine:
        return self.engines["matrix"]

    @property
    def alpha(self) -> float:
        """Matrix/vector engine speed ratio (the paper's alpha > 1)."""
        return self.matrix.peak_flops / self.vector.peak_flops

    def engine(self, which: str) -> Engine:
        return self.engines[which]


# --- Paper platforms (Table 1, FP64) -------------------------------------

A100_80G = HardwareSpec(
    name="A100-80GB",
    mem_bw=1.94e12,
    l2_bytes=40 * 2**20,
    link_bw=600e9 / 12,  # NVLink3: 600 GB/s total, 12 links
    engines={
        "vector": Engine("cuda-core-fp64", 9.7e12, "fp64"),
        "matrix": Engine("tensor-core-fp64", 19.5e12, "fp64"),
    },
)

GH200 = HardwareSpec(
    name="GH200",
    mem_bw=4.00e12,
    l2_bytes=50 * 2**20,
    link_bw=900e9 / 18,
    engines={
        "vector": Engine("cuda-core-fp64", 34.0e12, "fp64"),
        "matrix": Engine("tensor-core-fp64", 67.0e12, "fp64"),
    },
)

# --- H100 parts the port runs on (datasheet peaks, FP64) -------------------

H100_SXM = HardwareSpec(
    name="H100-SXM5",
    mem_bw=3.35e12,      # HBM3, datasheet
    l2_bytes=50 * 2**20,
    link_bw=900e9 / 18,  # NVLink4: 900 GB/s total, 18 links
    engines={
        "vector": Engine("cuda-core-fp64", 34.0e12, "fp64"),
        "matrix": Engine("tensor-core-fp64", 67.0e12, "fp64"),
    },
)

H100_PCIE = HardwareSpec(
    name="H100-PCIe",
    mem_bw=2.0e12,       # HBM2e, datasheet
    l2_bytes=50 * 2**20,
    link_bw=600e9 / 12,
    engines={
        "vector": Engine("cuda-core-fp64", 25.6e12, "fp64"),
        "matrix": Engine("tensor-core-fp64", 51.2e12, "fp64"),
    },
)

H100_NVL = HardwareSpec(
    name="H100-NVL",
    mem_bw=3.9e12,       # HBM3, datasheet
    l2_bytes=50 * 2**20,
    link_bw=600e9 / 12,
    engines={
        "vector": Engine("cuda-core-fp64", 30.0e12, "fp64"),
        "matrix": Engine("tensor-core-fp64", 60.0e12, "fp64"),
    },
)

# --- TPU target of the reference package ---------------------------------

TPU_V5E = HardwareSpec(
    name="TPU-v5e",
    mem_bw=819e9,
    l2_bytes=128 * 2**20,
    link_bw=50e9,
    engines={
        "vector": Engine("vpu-f32", 7.5e12, "f32"),
        "matrix": Engine("mxu-bf16", 197e12, "bf16"),
    },
)

#: Dense matmul peaks per dtype (FLOP/s, without sparsity), from each
#: part's NVIDIA datasheet: bfloat16 / float16 on the tensor cores,
#: float32 on the CUDA cores (outside the tensor cores: the port's float32
#: steps are IEEE, no TF32).  TPU-v5e's is the reference's: its matrix
#: engine is the bfloat16 MXU.  The FP64 engines above, which the advisor
#: and Eq. 23 use, are the datasheets' FP64 figures.
DENSE_PEAKS: Dict[str, Dict[str, float]] = {
    "A100-80GB": {"bfloat16": 312e12, "float16": 312e12, "float32": 19.5e12},
    "GH200": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
    "H100-SXM5": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
    "H100-PCIe": {"bfloat16": 756e12, "float16": 756e12, "float32": 51e12},
    "H100-NVL": {"bfloat16": 835e12, "float16": 835e12, "float32": 60e12},
    "TPU-v5e": {"bfloat16": TPU_V5E.matrix.peak_flops},
}


def dense_peak(hw: HardwareSpec, dtype: str = "bfloat16") -> float:
    """The dense matmul peak of ``hw`` at ``dtype`` ("bfloat16",
    "float32", ...), from ``DENSE_PEAKS``; a KeyError for a part or dtype
    it has no figure for."""
    try:
        return DENSE_PEAKS[hw.name][dtype]
    except KeyError:
        raise KeyError(f"no dense {dtype} peak for {hw.name!r}") from None


PLATFORMS: Dict[str, HardwareSpec] = {
    "a100": A100_80G,
    "gh200": GH200,
    "h100": H100_SXM,
    "h100pcie": H100_PCIE,
    "h100nvl": H100_NVL,
    "v5e": TPU_V5E,
}


def get_platform(name: str) -> HardwareSpec:
    """Look a platform up by key ('h100', 'a100', ...), ignoring - and _."""
    key = name.lower().replace("-", "").replace("_", "")
    for k, v in PLATFORMS.items():
        if k.replace("-", "") == key:
            return v
    raise KeyError(f"unknown platform {name!r}; have {sorted(PLATFORMS)}")


def spec_for_device_name(device_name: str) -> HardwareSpec:
    """The H100 part named by ``torch.cuda.get_device_name()``.

    Raises on any other card: a wrong spec would silently move every
    balance and ceiling the advisor reports.
    """
    name = device_name.upper()
    if "H100" not in name:
        raise ValueError(f"no HardwareSpec for device {device_name!r}")
    if "PCIE" in name:
        return H100_PCIE
    if "NVL" in name:
        return H100_NVL
    if "SXM" in name or "HBM3" in name or name.strip().endswith("H100"):
        return H100_SXM
    raise ValueError(f"unrecognised H100 part {device_name!r}")
