"""Sharded execution: split kernels, keep the paper's verdict.

The paper's Eq. 23/24 ceiling on matrix-engine speedups for memory-bound
kernels is a per-device statement; this package carries it across a
split.  :mod:`repro_torch.sharding.plan` describes *how* a registered
kernel call splits (data / rowblock-with-halo / head, one kind per §3
family shape) and accounts the traffic each shard moves;
:mod:`repro_torch.sharding.executor`'s :class:`ShardedExecutor` launches
the shards one after another through the engine dispatcher on one device
and *models* the N-way clock (max over shards); its :class:`MeshExecutor`
runs them on N ranks at once (:mod:`repro_torch.sharding.ranks`: gloo
processes, on the card all on one device) and *measures* the mesh step.
:mod:`~repro_torch.sharding.rules` gives every architecture's parameter,
cache and input specs, :mod:`~repro_torch.sharding.collective_matmul`
the ring and row-parallel matmuls the overlap probe times.

Consumers: ``repro_torch.core.dispatch`` attaches a :class:`ShardSpec` to
its memoized Advice when a mesh width is set; ``python -m
repro_torch.bench kernels --mesh N`` writes schema-5 records whose shard
claims ``repro_torch.report.claims`` verifies; ``repro_torch.serving``
packs batches per shard and charges the virtual clock the shard-parallel
maximum (``real_mesh``: the measured wall), and its elastic session
resizes and recovers shards.
"""
from .executor import MeshExecutor, MeshRun, ShardRun, ShardedExecutor
from .plan import (SHARD_KINDS, Shard, ShardPlan, ShardSpec,
                   combine_outputs, first_array, plan_for, shard_call,
                   spec_for, traffic)

__all__ = [
    "MeshExecutor", "MeshRun", "SHARD_KINDS", "Shard", "ShardPlan",
    "ShardRun", "ShardSpec",
    "ShardedExecutor", "combine_outputs", "first_array", "plan_for",
    "shard_call", "spec_for", "traffic",
]
