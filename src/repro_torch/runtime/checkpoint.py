"""Fault-tolerant checkpointing: atomic, resumable, async.

The reference's on-disk layout, so either package restores the other's
checkpoints (one directory per step):

    ckpt_dir/step_000123/
        manifest.json      -- tree structure, leaf keys, step, extra
        arrays.npz         -- flattened leaves keyed by path
    ckpt_dir/LATEST        -- text file naming the newest complete step

A leaf's key is its path as the reference's JAX key path prints it: dict
keys and sequence indices joined by ``/``, a NamedTuple's fields as
``.name`` (``1/.m/layers/attn/wq``), and an ``lm.LM`` as the reference's
parameter pytree, its layers stacked (``carry.params_to_numpy``).
Writes go to ``step_N.tmp`` then ``os.rename``: a partially written
checkpoint is never visible.  ``AsyncCheckpointer`` writes on a thread.
Restored tensors go to the template leaf's device and dtype (one device:
the reference's re-sharding has no counterpart here).

A bfloat16 leaf is stored as the reference stores it: raw 2-byte
``<V2`` records, the descriptor ``ml_dtypes``' bfloat16 writes into the
npz, so both packages write the same bytes for the same values.  Restore
reads a 2-byte void record back as bfloat16 and casts it to the template
leaf's dtype.  (The reference's own restore cannot read such a leaf: its
``astype`` has no cast from void.)

Restore without a ``step`` skips a corrupt step (truncated npz, mangled
manifest, a missing leaf) with a warning and tries the next older
complete one; a named ``step`` is strict.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..obs.log import LOG

__all__ = ["AsyncCheckpointer", "checkpoint_meta", "latest_step",
           "prune_old", "restore", "save"]

#: Failure modes of an on-disk checkpoint (vs. a caller bug): missing
#: or truncated files, a zip container np.load cannot open, mangled
#: manifest JSON, a leaf key the arrays archive no longer holds.
_CORRUPT = (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile)

#: The npy descriptor of a bfloat16 leaf: ``ml_dtypes``' bfloat16 saves
#: as little-endian 2-byte void records.
BF16_DESCR = "<V2"


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of one tensor leaf; bfloat16 as 2-byte void records."""
    # a copy: the training loop updates its tensors in place while the
    # writer thread saves
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _is_bf16_record(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
        and arr.dtype.names is None


def _savez(path: Path, flat: Dict[str, np.ndarray]) -> None:
    """``np.savez`` (uncompressed, one ``<key>.npy`` member per leaf),
    writing bfloat16 leaves under :data:`BF16_DESCR`."""
    from numpy.lib import format as npy
    with zipfile.ZipFile(path, mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in flat.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if not _is_bf16_record(val):
                    npy.write_array(fid, val)
                    continue
                npy.write_array_header_1_0(fid, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": val.shape})
                fid.write(np.ascontiguousarray(val).tobytes())


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{key: a host copy of the leaf} for every leaf, keyed as the
    reference keys."""
    if tree is None:
        return {}
    if isinstance(tree, nn.Module):
        from ..carry import params_to_numpy
        return _flatten(params_to_numpy(tree), prefix)
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        leaf = (_host(tree) if isinstance(tree, torch.Tensor)
                else np.array(tree))
        return {prefix.rstrip("/"): leaf}
    flat: Dict[str, np.ndarray] = {}
    for name, sub in items:
        flat.update(_flatten(sub, f"{prefix}{name}/"))
    return flat


def _structure(tree: Any) -> str:
    """A readable outline of the tree for the manifest."""
    if tree is None:
        return "None"
    if isinstance(tree, nn.Module):
        return f"LM({tree.cfg.name})"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(_structure(getattr(tree, f))
                            for f in tree._fields) + ")")
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(v) for v in tree) + ")"
    return "*"


def _write(ckpt_dir: Path, step: int, flat: Dict[str, np.ndarray],
           structure: str, extra: Optional[Dict]) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    _savez(tmp / "arrays.npz", flat)
    manifest = {"step": step, "treedef": structure, "keys": sorted(flat),
                "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # LATEST last: readers never see a name before its data is complete
    latest_tmp = ckpt_dir / "LATEST.tmp"
    latest_tmp.write_text(final.name)
    os.rename(latest_tmp, ckpt_dir / "LATEST")
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: Optional[Dict] = None) -> Path:
    """Atomic synchronous save of ``tree`` (tensors are copied to the
    host).  Returns the step's directory."""
    return _write(Path(ckpt_dir), step, _flatten(tree), _structure(tree),
                  extra)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The step named by ``LATEST``, or None when nothing is saved.

    ``LATEST`` is written (atomically, last) by :func:`save`, so the
    returned step is always a *complete* checkpoint directory."""
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip().split("_")[-1])


def _complete_steps(ckpt_dir: Path) -> List[int]:
    """All complete (renamed, non-``.tmp``) step numbers, newest first."""
    return sorted((int(p.name.split("_")[-1])
                   for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp")),
                  reverse=True)


def restore(ckpt_dir: str | Path, template: Any,
            step: Optional[int] = None) -> Any:
    """Restore into the structure of ``template``: each tensor leaf to its
    template's device and dtype, an ``LM`` as an ``LM`` of its config.

    With ``step=None`` (resume from the newest), a corrupt step on disk is
    skipped with a warning record and the next older complete step is
    tried; an explicit ``step`` is strict and raises on corruption.
    """
    ckpt_dir = Path(ckpt_dir)
    if step is not None:
        return _restore_step(ckpt_dir, template, step)
    steps = _complete_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    last_err: Optional[BaseException] = None
    for s in steps:
        try:
            return _restore_step(ckpt_dir, template, s)
        except _CORRUPT as err:
            LOG.warning(
                "checkpoint unreadable; falling back to the previous "
                "complete step", step=f"step_{s:08d}", dir=str(ckpt_dir),
                error=f"{type(err).__name__}: {err}")
            last_err = err
    raise FileNotFoundError(
        f"no readable checkpoint under {ckpt_dir} "
        f"({len(steps)} corrupt step(s) skipped)") from last_err


def _restore_step(ckpt_dir: Path, template: Any, step: int) -> Any:
    """Load one specific step directory into ``template``'s structure."""
    with np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz") as data:
        return _rebuild(template, "", data)


def _rebuild(template: Any, prefix: str, data) -> Any:
    if template is None:
        return None
    if isinstance(template, nn.Module):
        from ..carry import params_from_numpy
        from ..models.lm import LM
        nested: Dict[str, Any] = {}
        for key in data.files:
            if key.startswith(prefix):
                *parents, leaf = key[len(prefix):].split("/")
                node = nested
                for name in parents:
                    node = node.setdefault(name, {})
                node[leaf] = data[key]
        want = dict(template.named_parameters())
        got = params_from_numpy(nested, template.cfg,
                                device=next(iter(want.values())).device)
        return LM(template.cfg, {n: t.to(want[n].dtype)
                                 for n, t in got.named_parameters()})
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f),
                                         f"{prefix}.{f}/", data)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", data)
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, f"{prefix}{i}/", data)
                              for i, v in enumerate(template))
    arr = data[prefix.rstrip("/")]
    if isinstance(template, torch.Tensor):
        if _is_bf16_record(arr):
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=template.device, dtype=template.dtype)
    return arr.astype(np.asarray(template).dtype)


def checkpoint_meta(ckpt_dir: str | Path, step: int) -> Dict:
    """One step's manifest: tree structure, leaf keys, and the saver's
    ``extra`` sidecar."""
    folder = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((folder / "manifest.json").read_text())


class AsyncCheckpointer:
    """Double-buffered writer thread; ``wait()`` joins the in-flight save."""

    def __init__(self, ckpt_dir: str | Path):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot ``tree`` to host memory and write it on the writer
        thread.  Joins any in-flight save first (double-buffering depth
        one), so the caller blocks only on the copy to the host, never on
        disk."""
        self.wait()
        flat, structure = _flatten(tree), _structure(tree)

        def _run():
            try:
                _write(self.ckpt_dir, step, flat, structure, extra)
            except BaseException as e:  # surfaced on next wait()
                self._error = e
        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight save, re-raising any writer-thread error
        here on the caller's thread.  Idempotent; a no-op when nothing
        is in flight."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def prune_old(ckpt_dir: str | Path, keep: int = 3):
    """Retain the newest ``keep`` complete checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    for s in sorted(_complete_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
