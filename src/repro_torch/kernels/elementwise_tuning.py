"""Shared tile declarations for the elementwise families.

SCALE, STREAM Triad, and AXPY all launch through
``repro_torch.core.dispatch.elementwise_call``, so they share one tile
space.  ``block_rows * lanes`` is the element count one CTA covers.
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
