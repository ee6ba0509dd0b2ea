"""Host-sharded, deterministic, prefetching data pipeline.

Every host materializes only its slice of the global batch, derived from
(seed, step, host_index): a restart replays the exact global stream from
the step counter, and a replaced host regenerates its shard without
coordination.  The reference's numpy draws, in its order, so both
packages see the same batches bit for bit; the tensors go to an explicit
device.  Prefetch runs a background thread ahead (double buffering).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..models.config import ModelConfig

__all__ = ["TokenPipeline"]


class TokenPipeline:
    """Synthetic-corpus pipeline with the production interface.

    A real deployment swaps ``_materialize`` for file reads; the
    step/host addressing and the determinism contract stay the same.
    """

    def __init__(self, cfg: ModelConfig, global_batch: int, seq: int,
                 num_hosts: int = 1, host_index: int = 0, seed: int = 1234,
                 device="cuda"):
        if global_batch % num_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {num_hosts} hosts")
        self.cfg, self.seq = cfg, seq
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.num_hosts, self.host_index = num_hosts, host_index
        self.seed = seed
        self.device = torch.device(device)

    def _materialize(self, step: int) -> Dict[str, np.ndarray]:
        """This host's numpy batch of ``step``: tokens, next-token labels,
        the loss mask (zero over a vision config's patch positions), and
        the patch embeddings or the encoder's frames."""
        rng = np.random.default_rng((self.seed, step, self.host_index))
        b, s = self.local_batch, self.seq
        tokens = rng.integers(0, self.cfg.vocab, (b, s + 1), dtype=np.int32)
        out = {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "loss_mask": np.ones((b, s), np.float32),
        }
        if self.cfg.frontend == "vision":
            out["vision_embeds"] = rng.standard_normal(
                (b, self.cfg.frontend_len, self.cfg.frontend_dim)
            ).astype(np.float32)
            out["loss_mask"][:, :self.cfg.frontend_len] = 0.0
        if self.cfg.enc_dec:
            out["enc_frames"] = rng.standard_normal(
                (b, s, self.cfg.frontend_dim)).astype(np.float32)
        return out

    def _to_device(self, host: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` on the pipeline's device."""
        return self._to_device(self._materialize(step))

    def iterate(self, start_step: int = 0, prefetch: int = 2
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches from ``start_step`` on, materialized ``prefetch`` ahead
        on a background thread."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self._materialize(step))
                step += 1

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                yield self._to_device(q.get())
        finally:
            stop.set()
