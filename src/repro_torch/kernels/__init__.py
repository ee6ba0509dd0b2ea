"""Kernel families, unified behind the ``EngineOp`` registry.

Each family directory ships ``<name>.py`` (engine entry points and the
kernels' plain PyTorch versions), ``ref.py`` (oracle), and ``ops.py``
(public wrapper + one ``registry.register(EngineOp(...))`` call).  The
CUDA sources live in ``csrc/`` and are built by ``_ext``.
"""
from . import registry
from .registry import EngineOp

__all__ = ["EngineOp", "registry"]
