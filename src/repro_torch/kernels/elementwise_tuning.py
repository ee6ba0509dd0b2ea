"""Shared tile declarations for the elementwise families.

SCALE, STREAM Triad, and AXPY all launch through
``repro_torch.core.dispatch.elementwise_call``, so they share one tile
space: the reference's VMEM tile ``block_rows x lanes``.  On Hopper the
tile does not shape the launch (one 16-byte chunk per thread,
``repro_torch.core.dispatch.elementwise_call``); the space stays so that a
``tile_config`` and the tuner's search remain valid.
"""
from ..core.dispatch import ELEMENTWISE_BLOCK_ROWS, ELEMENTWISE_LANES

__all__ = ["ELEMENTWISE_TILE_DEFAULTS", "ELEMENTWISE_TILE_SPACE"]

#: Tile parameter name -> candidate values for elementwise families.
ELEMENTWISE_TILE_SPACE = {
    "block_rows": (128, 256, 512),
    "lanes": (512, 1024),
}

#: The static defaults ``elementwise_call`` applies when untuned.
ELEMENTWISE_TILE_DEFAULTS = {
    "block_rows": ELEMENTWISE_BLOCK_ROWS,
    "lanes": ELEMENTWISE_LANES,
}
