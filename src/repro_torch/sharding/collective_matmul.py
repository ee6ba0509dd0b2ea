"""Collective matmuls over the ranks of a mesh: overlap exchange with compute.

The paper's §4.1 lesson (fully overlapped communication is free) applied
to tensor-parallel matmuls, as the reference's ``collective_matmul``.
Each function runs inside one rank (``RankGroup.call``) on that rank's
shards, with the :class:`~repro_torch.sharding.ranks.Group` of its mesh
axis, and returns the full product on every rank:

``weight_gathered_matmul``: y = x @ w with w row-sharded (the FSDP /
ZeRO-3 layer shape).  Rather than ``x @ all_gather(w)``, the weight
shards rotate around a ring; each hop's partial product is issued before
the host waits for the next hop's shard, so the card computes while the
shard is on the wire.

``rowparallel_matmul``: y = x @ w with the contraction dim sharded
(Megatron row-parallel): one partial product per rank, then an
all-reduce.

``gathered_matmul`` is the serialized form the probe compares with:
``x @ all_gather(w)``, the product waiting for the whole gather.

The products are ``torch.matmul`` (IEEE float32: the ranks run without
TF32), as the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from .ranks import Group

__all__ = ["gathered_matmul", "rowparallel_matmul",
           "weight_gathered_matmul"]


def weight_gathered_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                           group: Group) -> torch.Tensor:
    """y = x @ w; x replicated, this rank's rows of w (rank r holds rows
    ``r*k .. (r+1)*k``).  Returns y on every rank."""
    p, r = group.size, group.rank
    k = w_shard.shape[0]
    assert x.shape[-1] == p * k, (x.shape, w_shard.shape, p)
    cur, owner, acc = w_shard, r, None
    for hop in range(p):
        pending = None
        if hop < p - 1:
            # shard `owner` goes to the next rank while its product runs
            pending = group.post({(r + 1) % p: cur},
                                 {(r - 1) % p: cur})
        part = x[..., owner * k:(owner + 1) * k] @ cur
        acc = part if acc is None else acc + part
        if pending is not None:
            cur = pending.wait()[(r - 1) % p]
            owner = (owner - 1) % p
    return acc


def rowparallel_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor,
                       group: Group) -> torch.Tensor:
    """y = x @ w; this rank's columns of x and rows of w (the contraction
    dim sharded alike).  Returns y on every rank."""
    part = x_shard.reshape(-1, x_shard.shape[-1]) @ w_shard
    out = group.all_reduce(part)
    return out.reshape(*x_shard.shape[:-1], w_shard.shape[-1])


def gathered_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                    group: Group) -> torch.Tensor:
    """y = x @ all_gather(w): the gather completes before the product."""
    return x @ torch.cat(group.all_gather(w_shard), dim=0)
