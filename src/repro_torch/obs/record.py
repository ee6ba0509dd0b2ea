"""Device-side counters: tensors a step leaves on the card, read once.

A layer that counts what it did (the expert share: rows routed to each
held expert) hands the count to :data:`RECORD` as the tensor it already
has on the card.  While nothing records, :meth:`DeviceRecord.add` is one
flag check; while a reader records (:meth:`DeviceRecord.start`), each
tensor is kept, in call order, without a copy and without waiting for
the card.  :meth:`DeviceRecord.stop`, called after the reader's own
synchronisation, concatenates each name's tensors along their first axis
and brings them to the host in one copy per name.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["DeviceRecord", "RECORD"]


class DeviceRecord:
    """Named lists of device tensors, kept while recording (module
    docstring)."""

    def __init__(self) -> None:
        self.enabled = False
        self._items: Dict[str, List[torch.Tensor]] = {}

    def add(self, name: str, t: torch.Tensor) -> None:
        """Keep ``t`` under ``name`` while recording (else nothing)."""
        if self.enabled:
            self._items.setdefault(name, []).append(t.detach())

    def start(self) -> None:
        """Drop what was kept and record from now on."""
        self._items = {}
        self.enabled = True

    def stop(self) -> Dict[str, torch.Tensor]:
        """Stop recording; each name's tensors, concatenated in call order
        along their first axis, on the host."""
        self.enabled = False
        items, self._items = self._items, {}
        return {k: torch.cat(v).cpu() for k, v in items.items()}


#: The process's record.
RECORD = DeviceRecord()
