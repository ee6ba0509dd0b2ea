"""Meshes of ranks: the port's stand-in for the reference's device meshes.

A :class:`Mesh` is a small object holding a shape and its axis names;
once live (:meth:`Mesh.live`) it also holds the rank group its
collectives run over (:mod:`repro_torch.sharding.ranks`).  Where the
reference forces N XLA host devices, the port starts N ranks of
``torch.distributed``: the parent process is rank 0, the others are
processes it spawns, and they talk over gloo.  On the card every rank
binds ``cuda:0``; on the CPU (``backend="plain"``) every rank runs the
plain versions.

``host_device_count(n)`` sets how many ranks a process may start (the
reference's ``--xla_force_host_platform_device_count``); a mesh or a
:class:`~repro_torch.sharding.MeshExecutor` wider than that raises
``RuntimeError`` naming it, and nothing falls back to the virtual clock.
``make_production_mesh`` gives the reference's 256- and 512-way shapes
without starting a rank.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Mesh", "current_mesh", "data_mesh", "host_device_count",
           "host_ranks", "make_auto_mesh", "make_production_mesh",
           "make_test_mesh", "mesh_context"]

#: How many ranks this process may start (``host_device_count``).
_HOST_RANKS = 1

#: The mesh set by the innermost ``mesh_context``.
_CURRENT: list = []


def host_device_count(n: int) -> int:
    """Let this process start up to *n* ranks; returns *n*.

    The port's form of the reference's forced host device count: a mesh
    of more ranks than this raises.  A live rank pool narrower than *n*
    is closed, so the next mesh starts the wider one.
    """
    global _HOST_RANKS
    n = int(n)
    if n < 1:
        raise ValueError(f"host_device_count needs n >= 1, got {n}")
    if n != _HOST_RANKS:
        from ..sharding import ranks
        ranks.close_pool()
    _HOST_RANKS = n
    return n


def host_ranks() -> int:
    """How many ranks this process may start."""
    return _HOST_RANKS


def _need_ranks(n: int, what: str) -> None:
    if n > _HOST_RANKS:
        raise RuntimeError(
            f"{what} needs {n} ranks but this process may start "
            f"{_HOST_RANKS}. Allow them first: "
            f"repro_torch.launch.mesh.host_device_count({n}) (the "
            f"sweep's and serve's --real and launch.train's --devices do "
            f"this for you).")


class Mesh:
    """A mesh shape with named axes; live, the rank group under it.

    ``shape`` maps each axis name to its width (as a JAX mesh's does),
    ``devices`` is the grid of rank numbers, rank ``r`` at the row-major
    position ``r``.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        names = tuple(str(a) for a in axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axes {names} differ "
                             f"in length")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        self.group = None

    @property
    def size(self) -> int:
        """How many ranks the mesh spans."""
        return int(self.devices.size)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Rank *rank*'s index along each axis."""
        return tuple(int(i) for i in
                     np.unravel_index(rank, self.devices.shape))

    def live(self):
        """The rank group of this mesh's ranks, started on first use (a
        process-wide pool of ``host_device_count`` ranks; the mesh takes
        its first ``size``)."""
        if self.group is None:
            _need_ranks(self.size, f"a {tuple(self.shape.values())} mesh")
            from ..sharding import ranks
            self.group = ranks.pool()
        return self.group

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_auto_mesh(shape, axes) -> Mesh:
    """A mesh of *shape* over *axes* (the reference's name; no rank is
    started until it is used)."""
    return Mesh(shape, axes)


@contextlib.contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    """Make *mesh* the current one (``current_mesh``) inside the block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``mesh_context``, or None."""
    return _CURRENT[-1] if _CURRENT else None


def data_mesh(num_shards: int) -> Mesh:
    """The 1-D ``"data"`` mesh of a sharded kernel call, clamped to the
    ranks this process may start (never less than 1), as the reference
    clamps to its devices."""
    width = max(1, min(int(num_shards), _HOST_RANKS))
    return make_auto_mesh((width,), ("data",))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 256-rank single-pod (or 512-rank two-pod) mesh shape; starts
    no rank."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A small mesh for the multi-rank tests (8 ranks by default)."""
    return make_auto_mesh(shape, axes)
