"""ShardPlan: how one kernel call splits into shards.

The paper's Eq. 23/24 ceiling (a matrix engine buys at most
2 - 2/(1+alpha), and never more than 1 + I/B, on a memory-bound kernel) is
stated **per device**.  Splitting a call must not change that verdict: a
data-parallel shard of a memory-bound kernel moves 1/N-th of the bytes at
the same operational intensity (Eq. 2: W and Q shrink together), so
per-shard bandwidth, not the compute engine, still sets the roof.  This
module plans the split, accounts the traffic (including halo duplication,
the one place sharding adds bytes), and hands the per-shard calls back to
``repro_torch.core.dispatch`` unchanged.

Three shard kinds cover every registered family (paper §3 suite):

* ``'data'`` -- elementwise families (SCALE, STREAM Triad, AXPY): the
  flattened element axis splits into contiguous ranges; shards are
  independent (no halo, no exchange).
* ``'rowblock'`` -- SpMV and stencil: contiguous row blocks.  Block-ELL
  SpMV shards block-rows with the dense ``x`` replicated (halo 0); a
  stencil shard also reads ``halo = t*r`` rows from each neighbour (the
  trapezoid dependency of ``t`` fused steps at radius ``r``, paper
  Eq. 13), sliced from the global array as a neighbour exchange would
  deliver them, then cropped from the shard's output.
* ``'head'`` -- decode attention: KV heads split across shards; each head
  attends to its own cache slice, so head-sharding is exact with no
  exchange.

The plans are pure data and their JSON is the reference package's for
the same shapes.  What differs is how a plan meets live tensors
(:func:`shard_call`): the hand-written kernels take contiguous, 16-byte
aligned tensors, so a shard whose slice is a strided view (a head slice of
q on axis 1, of K / V on axis 2) or starts off a 16-byte boundary is
copied into a tensor of its own; and a head shard carries the unsharded
call's ``B * KH`` as ``split_pairs``, so flash-decode cuts each shard's
heads into the same split-S ranges as the unsharded call and merges them
in the same order (bit for bit; see ``kernels._ext.attention``).

The plan's per-shard ranges are also the fault-recovery contract: when a
shard dies mid-batch, ``repro_torch.serving.elastic.redispatch_failed_shard``
replays exactly that shard's :func:`shard_call` slice (halo included for
rowblock splits) and the recovered output is bit-identical to the lost
one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

__all__ = [
    "SHARD_KINDS", "Shard", "ShardPlan", "ShardSpec", "combine_outputs",
    "first_array", "plan_for", "shard_call", "spec_for", "traffic",
]

#: The shard kinds the planner understands, in paper-§3 family order.
SHARD_KINDS = ("data", "rowblock", "head")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The compact description of one sharded execution (hashable).

    What ``Advice.shard_spec`` carries and schema-5 BENCH records
    serialize: the split ``kind``, how many shards, the mesh axis name
    they map onto, and the per-boundary ``halo`` rows a rowblock split
    must exchange (0 for data/head splits -- Eq. 2's W and Q then scale
    exactly together, leaving the per-shard intensity, and with it the
    Eq. 23/24 ceiling, unchanged).
    """

    kind: str
    num_shards: int
    axis: str = "data"
    halo: int = 0

    def __post_init__(self):
        if self.kind not in SHARD_KINDS:
            raise ValueError(f"unknown shard kind {self.kind!r}; "
                             f"expected one of {SHARD_KINDS}")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, "
                             f"got {self.num_shards}")
        if self.halo < 0:
            raise ValueError(f"halo must be >= 0, got {self.halo}")

    def to_json(self) -> Dict[str, Any]:
        """The spec as a plain JSON-serializable dict (schema-5 field)."""
        return {"kind": self.kind, "num_shards": int(self.num_shards),
                "axis": self.axis, "halo": int(self.halo)}

    @classmethod
    def from_json(cls, raw: Mapping[str, Any]) -> "ShardSpec":
        """Parse a spec dict; raises on missing fields / bad values."""
        return cls(kind=str(raw["kind"]),
                   num_shards=int(raw["num_shards"]),
                   axis=str(raw.get("axis", "data")),
                   halo=int(raw.get("halo", 0)))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard's range on the split axis, plus its borrowed halo.

    ``[start, stop)`` is the range this shard *owns* (and whose output it
    contributes); ``lo``/``hi`` are the halo rows borrowed from the
    previous/next shard, clipped at the domain edges.
    """

    index: int
    start: int
    stop: int
    lo: int = 0
    hi: int = 0

    @property
    def owned(self) -> int:
        """How many rows/elements/heads this shard owns."""
        return self.stop - self.start

    @property
    def read_range(self) -> Tuple[int, int]:
        """The global input range this shard reads (owned + halo)."""
        return (self.start - self.lo, self.stop + self.hi)

    def to_json(self) -> Dict[str, int]:
        """The shard as a plain JSON-serializable dict."""
        return {"index": self.index, "start": self.start,
                "stop": self.stop, "lo": self.lo, "hi": self.hi}

    @classmethod
    def from_json(cls, raw: Mapping[str, Any]) -> "Shard":
        """Parse one shard dict; raises on missing fields."""
        return cls(index=int(raw["index"]), start=int(raw["start"]),
                   stop=int(raw["stop"]), lo=int(raw.get("lo", 0)),
                   hi=int(raw.get("hi", 0)))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A ShardSpec made concrete: the per-shard ranges over one extent.

    ``extent`` is the length of the split axis (flattened elements,
    block-rows, leading rows, or KV heads depending on ``spec.kind``).
    Plans are pure data, JSON round-trippable via
    :meth:`to_json`/:meth:`from_json`.
    """

    spec: ShardSpec
    shards: Tuple[Shard, ...]
    extent: int

    def __post_init__(self):
        if len(self.shards) != self.spec.num_shards:
            raise ValueError(
                f"plan has {len(self.shards)} shards but its spec says "
                f"{self.spec.num_shards}")
        covered = sum(s.owned for s in self.shards)
        if covered != self.extent:
            raise ValueError(
                f"shards own {covered} of {self.extent} rows; a plan "
                "must partition its extent exactly")

    def to_json(self) -> Dict[str, Any]:
        """The plan as a plain JSON-serializable dict (round-trips)."""
        return {"spec": self.spec.to_json(),
                "shards": [s.to_json() for s in self.shards],
                "extent": int(self.extent)}

    @classmethod
    def from_json(cls, raw: Mapping[str, Any]) -> "ShardPlan":
        """Parse a plan dict produced by :meth:`to_json`."""
        return cls(spec=ShardSpec.from_json(raw["spec"]),
                   shards=tuple(Shard.from_json(s)
                                for s in raw["shards"]),
                   extent=int(raw["extent"]))


def _even_ranges(extent: int, num_shards: int) -> List[Tuple[int, int]]:
    """Split [0, extent) into num_shards contiguous near-even ranges."""
    base, rem = divmod(extent, num_shards)
    ranges, start = [], 0
    for i in range(num_shards):
        stop = start + base + (1 if i < rem else 0)
        ranges.append((start, stop))
        start = stop
    return ranges


def _build(kind: str, extent: int, num_shards: int,
           halo: int = 0) -> ShardPlan:
    """Construct a plan of *kind* over *extent* with edge-clipped halos."""
    n = max(1, min(int(num_shards), int(extent)))
    shards = []
    for i, (start, stop) in enumerate(_even_ranges(extent, n)):
        shards.append(Shard(index=i, start=start, stop=stop,
                            lo=min(halo, start),
                            hi=min(halo, extent - stop)))
    spec = ShardSpec(kind=kind, num_shards=n, halo=halo)
    return ShardPlan(spec=spec, shards=tuple(shards), extent=extent)


def _is_arrayish(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def first_array(args: Sequence[Any]):
    """The first array-ish call argument (split-extent / shape template)."""
    for a in args:
        if _is_arrayish(a):
            return a
    raise ValueError("no array argument to plan a shard split over")


def spec_for(op, num_shards: int, *args, **kwargs) -> ShardSpec:
    """The ShardSpec dispatch attaches to Advice for one op + call.

    Plans the split (:func:`plan_for`) and keeps the compact spec; paid
    once per Advice cache miss.  ``num_shards`` is clamped to the split
    extent, so a 4-way mesh over a 2-head cache plans 2 useful shards.
    """
    return plan_for(op, num_shards, *args, **kwargs).spec


def plan_for(op, num_shards: int, *args, **kwargs) -> ShardPlan:
    """Plan one op call's split into *num_shards* shards.

    The op's ``shard_kind`` picks the planner; the extent comes from the
    live arguments (flattened size, block-rows, leading rows, or KV
    heads) and the halo from the op's ``shard_halo`` hook (``t*r`` for a
    stencil at depth t, Eq. 13; 0 everywhere else).
    """
    kind = getattr(op, "shard_kind", "data")
    halo = 0
    halo_fn = getattr(op, "shard_halo", None)
    if halo_fn is not None:
        halo = int(halo_fn(*args, **kwargs))
    if kind == "data":
        extent = int(first_array(args).numel())
    elif kind == "rowblock":
        first = args[0]
        if hasattr(first, "blocks"):        # block-ELL: split block-rows
            extent = int(first.blocks.shape[0])
        else:                               # stencil grid: leading rows
            extent = int(first.shape[0])
    elif kind == "head":
        extent = int(args[0].shape[1])      # q: (B, KH, G, Dh)
    else:
        raise ValueError(f"op {op.name!r} declares unknown shard kind "
                         f"{kind!r}; expected one of {SHARD_KINDS}")
    return _build(kind, extent, num_shards, halo=halo)


# --------------------------------------------------------------------------
# applying a plan to live call arguments
# --------------------------------------------------------------------------

def _slice_rows(a, start: int, stop: int, axis: int = 0):
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop)
    return a[tuple(idx)]


def _own(t: torch.Tensor) -> torch.Tensor:
    """*t* itself where a kernel can take it (contiguous, 16-byte
    aligned), else a contiguous copy of its own."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def shard_call(plan: ShardPlan, shard: Shard, args: tuple,
               kwargs: dict) -> Tuple[tuple, dict]:
    """The (args, kwargs) for one shard's kernel launch.

    Tensor arguments are sliced per ``plan.spec.kind`` (and made
    contiguous and aligned, see the module docstring); scalars and
    non-split operands (the SpMV ``x`` vector, the KV length) ride along
    unchanged.  For rowblock splits the slice includes the shard's halo
    rows.  A head shard's kwargs gain ``split_pairs``, the unsharded
    call's ``B * KH``.
    """
    kind = plan.spec.kind
    lo_start, hi_stop = shard.read_range
    if kind == "data":
        out = []
        for a in args:
            if _is_arrayish(a):
                out.append(_own(a.reshape(-1)[shard.start:shard.stop]))
            else:
                out.append(a)
        return tuple(out), dict(kwargs)
    if kind == "rowblock":
        first = args[0]
        if hasattr(first, "blocks"):
            bell = first
            part = type(bell)(
                blocks=_own(_slice_rows(bell.blocks, shard.start,
                                        shard.stop)),
                cols=_own(_slice_rows(bell.cols, shard.start, shard.stop)),
                shape=(shard.owned * bell.bm, bell.shape[1]))
            return (part,) + tuple(args[1:]), dict(kwargs)
        sliced = _own(_slice_rows(first, lo_start, hi_stop))
        return (sliced,) + tuple(args[1:]), dict(kwargs)
    if kind == "head":
        q, k, v = args[0], args[1], args[2]
        skw = dict(kwargs)
        if skw.get("split_pairs") is None:
            skw["split_pairs"] = int(q.shape[0]) * int(q.shape[1])
        return ((_own(_slice_rows(q, shard.start, shard.stop, axis=1)),
                 _own(_slice_rows(k, shard.start, shard.stop, axis=2)),
                 _own(_slice_rows(v, shard.start, shard.stop, axis=2)))
                + tuple(args[3:]), skw)
    raise ValueError(f"unknown shard kind {kind!r}")


def combine_outputs(plan: ShardPlan, outputs: Sequence[Any],
                    template: Any = None):
    """Reassemble per-shard outputs into the unsharded result.

    The inverse of :func:`shard_call`: concatenate owned ranges (halo rows
    are cropped from rowblock outputs first) along the split axis
    (``torch.cat`` on the outputs' device) and restore the template's
    shape for flattened data splits.  The shard outputs already hold the
    exact unsharded values.
    """
    kind = plan.spec.kind
    if kind == "data":
        flat = torch.cat([o.reshape(-1) for o in outputs])
        if template is not None and _is_arrayish(template):
            return flat.reshape(template.shape)
        return flat
    if kind == "rowblock":
        cropped = []
        for shard, out in zip(plan.shards, outputs):
            if shard.lo or shard.hi:
                out = _slice_rows(out, shard.lo, shard.lo + shard.owned)
            cropped.append(out)
        return torch.cat(cropped, dim=0)
    if kind == "head":
        return torch.cat(list(outputs), dim=1)
    raise ValueError(f"unknown shard kind {kind!r}")


def traffic(op, plan: ShardPlan, args: tuple,
            kwargs: dict) -> Dict[str, float]:
    """The plan's byte accounting, via the op's own Eq. 2 traits.

    Per-shard traffic comes from running the family's ``traits`` factory
    on each shard's sliced arguments, so the numbers the claims layer
    checks (``shard_bytes``, ``agg_bytes`` vs the unsharded
    ``total_bytes``, the worst per-shard ``shard_intensity``) never drift
    from the analytic layer.  ``agg_bytes - total_bytes`` is the halo
    duplication; ``wire_bytes`` is the part of it a real mesh would move
    between devices: the halo rows a stencil split borrows (sum over
    shards of (lo + hi) x row bytes).
    """
    total = op.traits(*args, **kwargs)
    shard_traits = []
    for s in plan.shards:
        sargs, skw = shard_call(plan, s, args, kwargs)
        shard_traits.append(op.traits(*sargs, **skw))
        del sargs, skw
    agg = float(sum(t.traffic_bytes for t in shard_traits))
    wire = 0.0
    if plan.spec.kind == "rowblock" and plan.spec.halo > 0:
        first = args[0]
        if not hasattr(first, "blocks"):    # stencil grid rows
            row_elems = 1
            for d in first.shape[1:]:
                row_elems *= int(d)
            row_bytes = row_elems * first.element_size()
            wire = float(sum(s.lo + s.hi for s in plan.shards)
                         * row_bytes)
    return {
        "total_bytes": float(total.traffic_bytes),
        "agg_bytes": agg,
        "wire_bytes": wire,
        # the two worsts are taken independently: the biggest mover sets
        # the per-shard memory floor, the highest intensity is what the
        # shard_ceiling claim must hold below B_vector
        "shard_bytes": float(max(t.traffic_bytes for t in shard_traits)),
        "shard_intensity": float(max(t.intensity for t in shard_traits)),
    }
