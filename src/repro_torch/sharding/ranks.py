"""The ranks of a measured mesh: N processes of ``torch.distributed``.

A :class:`RankGroup` starts ``size - 1`` processes with
``torch.multiprocessing``'s spawn context once and keeps them for many
calls; the calling process is rank 0.  Every rank joins one gloo group
over a ``FileStore`` in a temporary directory (no TCP port is fixed: the
ranks meet through the file and gloo picks loopback ports), and a
narrower group over ranks ``0 .. w-1`` is made the first time a call
asks for width ``w`` (any other set of ranks: ``subgroup``).

:meth:`RankGroup.call` runs one module-level function on ranks
``0 .. w-1`` at once, ``fn(ctx, *args)`` with rank r's own arguments:
the parent runs rank 0's share itself while the others run theirs.
Tensors on the card reach the other ranks through CUDA IPC (the
``torch.multiprocessing`` queues), and the parent holds every argument
until all ranks have answered; a rank keeps what it must reuse in
``ctx.held``.  Every wait has a timeout; a rank that raises leaves the
group, the parent tears the group down and raises the rank's error.

NCCL refuses two ranks on one card, so the collectives here are gloo's,
and gloo takes no CUDA tensor in ``send`` / ``recv``: :class:`Group`
stages every message of a tensor on the card through pinned host
buffers, and that copy is part of the collective's time.  Ranks that
share one card are time-sliced between their CUDA contexts.
"""
from __future__ import annotations

import atexit
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["DEFAULT_TIMEOUT_S", "Group", "RankContext", "RankGroup",
           "close_pool", "pool"]

#: Seconds any wait of the group may take (a collective, a rank's answer,
#: the group's start) before it fails.
DEFAULT_TIMEOUT_S = 180.0


def _wire(t: torch.Tensor) -> torch.Tensor:
    """*t* as gloo moves it: bfloat16 travels as its int16 bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


class _Pending:
    """Posted sends and receives; :meth:`wait` finishes them and returns
    the received tensors on the rank's device."""

    def __init__(self, works, staged):
        self._works = works
        self._staged = staged

    def wait(self) -> Dict[int, torch.Tensor]:
        for w in self._works:
            w.wait()
        # a blocking copy: the pinned buffer is reused by the next message
        return {peer: buf.to(like.device) if like.is_cuda else buf.clone()
                for peer, (buf, like) in self._staged.items()}


class Group:
    """One gloo group over ranks ``0 .. size-1``, seen from one rank.

    The helpers take and return tensors on the rank's device; a tensor on
    the card goes to the wire through a pinned host buffer (kept for the
    next message of its shape) and comes back from one.
    """

    def __init__(self, pg, rank: int, size: int):
        self.pg = pg
        self.rank = rank
        self.size = size
        self._bufs: Dict[tuple, torch.Tensor] = {}

    def _host(self, role: tuple, like: torch.Tensor) -> torch.Tensor:
        key = role + (tuple(like.shape), like.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(
                like.shape, dtype=like.dtype, pin_memory=like.is_cuda)
        return buf

    def barrier(self) -> None:
        """Wait for every rank of the group."""
        self.pg.barrier().wait()

    @staticmethod
    def _tag(src: int, dst: int) -> int:
        # one tag per direction, so two peers that are each other's
        # neighbour on both sides (a ring of 2) never mix their messages
        return 0 if dst > src else 1

    def post(self, sends: Dict[int, torch.Tensor],
             recvs: Dict[int, torch.Tensor]) -> _Pending:
        """Post a send of ``sends[peer]`` to each peer and a receive of a
        tensor shaped like ``recvs[peer]`` from each, without waiting."""
        works, staged = [], {}
        for peer, like in recvs.items():
            buf = self._host(("recv", peer), like)
            staged[peer] = (buf, like)
            works.append(self.pg.recv([_wire(buf)], peer,
                                      self._tag(peer, self.rank)))
        for peer, t in sends.items():
            host = self._host(("send", peer), t)
            host.copy_(t)
            works.append(self.pg.send([_wire(host)], peer,
                                      self._tag(self.rank, peer)))
        return _Pending(works, staged)

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """:meth:`post`, then wait: the received tensors by peer."""
        return self.post(sends, recvs).wait()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of *t* over the group (a new tensor)."""
        host = self._host(("reduce",), t)
        host.copy_(t)
        self.pg.allreduce([host]).wait()
        return host.to(t.device) if t.is_cuda else host.clone()

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's *t*, in rank order (each rank's the same shape)."""
        host = self._host(("gather",), t)
        host.copy_(t)
        outs = [torch.empty_like(host) for _ in range(self.size)]
        self.pg.allgather([[_wire(o) for o in outs]], [_wire(host)]).wait()
        if t.is_cuda:
            return [o.to(t.device) for o in outs]
        return outs


class RankContext:
    """What a rank's function sees: its rank, the pool's size, its
    groups and the objects it holds between calls."""

    def __init__(self, rank: int, size: int, store_path: str,
                 timeout_s: float):
        from torch.distributed import FileStore
        self.rank = rank
        self.size = size
        self.timeout_s = timeout_s
        self._store = FileStore(store_path, -1)
        self._groups: Dict[tuple, Group] = {}
        #: objects this rank keeps from one call to the next, by handle
        self.held: Dict[Any, Any] = {}

    def group(self, width: int) -> Group:
        """The gloo group over ranks ``0 .. width-1``."""
        return self.subgroup(tuple(range(width)))

    def subgroup(self, members: Sequence[int]) -> Group:
        """The gloo group over the pool ranks *members*, in that order (a
        member's rank in it is its index).  Made on first use: every
        member must ask for it in the same call."""
        members = tuple(int(m) for m in members)
        g = self._groups.get(members)
        if g is None:
            from torch.distributed import PrefixStore, ProcessGroupGloo
            opts = ProcessGroupGloo._Options()
            opts._devices = [ProcessGroupGloo.create_device(
                hostname="127.0.0.1")]
            opts._timeout = datetime.timedelta(seconds=self.timeout_s)
            name = "ranks-" + "-".join(map(str, members))
            pg = ProcessGroupGloo(PrefixStore(name, self._store),
                                  members.index(self.rank), len(members),
                                  opts)
            g = self._groups[members] = Group(pg, members.index(self.rank),
                                              len(members))
        return g


def _worker(rank: int, size: int, store_path: str, timeout_s: float,
            inbox, outbox) -> None:
    """One rank's loop: run each task, answer, leave on error or None."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = RankContext(rank, size, store_path, timeout_s)
    while True:
        task = inbox.get()
        if task is None:
            return
        fn, args, kwargs = task
        try:
            outbox.put(("ok", fn(ctx, *args, **kwargs)))
        except BaseException:
            outbox.put(("err", traceback.format_exc()))
            # leave: the closed sockets end the peers' waits on this rank
            outbox.close()
            outbox.join_thread()
            return
        del task, fn, args, kwargs


def _hello(ctx: RankContext, width: int) -> int:
    ctx.group(width).barrier()
    return ctx.rank


def _launches(ctx: RankContext, reset: bool) -> Dict[str, int]:
    from ..kernels import _ext
    counts = dict(_ext.LAUNCHES)
    if reset:
        _ext.reset_launches()
    return counts


class RankGroup:
    """``size`` ranks: this process (rank 0) and ``size - 1`` spawned
    ones, kept until :meth:`close`."""

    def __init__(self, size: int, *, timeout_s: float = DEFAULT_TIMEOUT_S):
        import torch.multiprocessing as mp
        if size < 1:
            raise ValueError(f"a rank group needs size >= 1, got {size}")
        self.size = int(size)
        self.timeout_s = float(timeout_s)
        if torch.cuda.is_available():
            # the ranks load the kernels this process built; they never
            # compile
            from ..kernels import _ext
            _ext.build()
        self._dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        store = os.path.join(self._dir, "store")
        spawn = mp.get_context("spawn")
        self._inboxes = [None] + [spawn.Queue()
                                  for _ in range(1, self.size)]
        self._outboxes = [None] + [spawn.Queue()
                                   for _ in range(1, self.size)]
        self._procs = [None]
        for r in range(1, self.size):
            p = spawn.Process(target=_worker, daemon=True,
                              args=(r, self.size, store, self.timeout_s,
                                    self._inboxes[r], self._outboxes[r]),
                              name=f"repro_torch-rank{r}")
            p.start()
            self._procs.append(p)
        self.ctx = RankContext(0, self.size, store, self.timeout_s)
        self.closed = False
        self.call(self.size, _hello, [(self.size,)] * self.size)

    def call(self, width: int, fn: Callable, args: Sequence[tuple],
             **kwargs) -> List[Any]:
        """``fn(ctx, *args[r], **kwargs)`` on ranks ``0 .. width-1`` at
        once; their answers in rank order."""
        if self.closed:
            raise RuntimeError("the rank group is closed")
        if not 1 <= width <= self.size:
            raise ValueError(f"width {width} outside this group of "
                             f"{self.size} ranks")
        if len(args) != width:
            raise ValueError(f"{len(args)} argument tuples for {width} "
                             f"ranks")
        for r in range(1, width):
            self._inboxes[r].put((fn, tuple(args[r]), kwargs))
        try:
            answers = [fn(self.ctx, *args[0], **kwargs)]
            for r in range(1, width):
                answers.append(self._answer(r))
        except BaseException:
            self.close()
            raise
        return answers

    def _answer(self, r: int) -> Any:
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                status, value = self._outboxes[r].get(timeout=1.0)
                break
            except queue.Empty:
                if not self._procs[r].is_alive():
                    raise RuntimeError(
                        f"rank {r} died (exit code "
                        f"{self._procs[r].exitcode})") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {r} gave no answer in {self.timeout_s} s")
        if status != "ok":
            raise RuntimeError(f"rank {r} raised:\n{value}")
        return value

    def launches(self, reset: bool = False) -> Dict[str, int]:
        """The kernel launches ranks ``1 .. size-1`` counted since their
        last reset, summed by kernel (rank 0's are this process's own
        ``_ext.LAUNCHES``); ``reset=True`` sets theirs to 0 after."""
        total: Dict[str, int] = {}
        if self.size == 1:
            return total
        for counts in self.call(self.size, _launches,
                                [(False,)] + [(reset,)] * (self.size - 1)
                                )[1:]:
            for name, n in counts.items():
                total[name] = total.get(name, 0) + n
        return total

    def close(self) -> None:
        """Stop every rank (a goodbye, then a join with a timeout, then
        terminate) and remove the store."""
        if self.closed:
            return
        self.closed = True
        for r in range(1, self.size):
            try:
                self._inboxes[r].put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 10.0
        for p in self._procs[1:]:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for q in self._inboxes[1:] + self._outboxes[1:]:
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)
        if torch.cuda.is_available():
            torch.cuda.ipc_collect()


_POOL: Optional[RankGroup] = None


def pool() -> RankGroup:
    """This process's rank group of ``host_device_count`` ranks, started
    on first use and kept until :func:`close_pool` or exit."""
    global _POOL
    from ..launch.mesh import host_ranks
    if _POOL is None or _POOL.closed or _POOL.size != host_ranks():
        close_pool()
        _POOL = RankGroup(host_ranks())
    return _POOL


def close_pool() -> None:
    """Stop this process's rank group, if one runs."""
    global _POOL
    if _POOL is not None:
        _POOL.close()
        _POOL = None


atexit.register(close_pool)
