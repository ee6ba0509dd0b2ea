"""Decode engine: prefill + greedy decode with per-phase timing.

The executable half of the model-scale verdict (``advisor_map``): one
:class:`DecodeEngine` owns a config's parameters and the two entry
points, ``prefill`` (full prompt pass, caches built once) and
``decode_step`` (one token against the KV caches through ``lm``'s layer
loop).  Attention is registry-dispatched by default
(``attention_impl='registry'``): every GQA layer's cache scan goes
through the registered flash-decode op, the hand-written kernel on the
card, and the engine ('vector'|'matrix'|'auto') is a constructor flag.
MLA layers decode in the absorbed latent form and SSM layers from their
recurrent state, and run no flash-decode; a hybrid's shared attention
block runs it once per super-block (``flash_decode_layers`` counts the
layers that do).  An encoder-decoder's prompt batch carries its audio
frames (``enc_frames``): prefill runs the encoder once and caches every
decoder layer's cross K / V (``ck`` / ``cv``, the encoder's length), and
each decode step reads them with the plain dense softmax; only the
decoder's self-attention runs flash-decode.

Everything lives on ``device``, ``"cuda"`` by default; the CPU runs the
kernels' plain versions and is what the tests ask for.  The reference's
``unroll=`` (an unrolled ``lax.scan`` to diff against) has no
counterpart: the layer loop here is already a plain Python loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..data.synthetic import make_batch
from . import lm
from .advisor_map import ModelVerdict, model_verdict, step_traits
from .config import ModelConfig

__all__ = ["DecodeEngine", "GenerationResult"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: the port runs on the card by "
                           "default; pass device='cpu' for the plain path")
    return dev


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """One greedy generation: tokens + the phase-split timings."""

    tokens: torch.Tensor       # (B, gen) greedy tokens (incl. first)
    logits: torch.Tensor       # (B, vocab_padded) last-step logits
    caches: Any                # final KV caches
    prefill_s: float           # prompt-pass wall time
    decode_s: float            # all decode steps' wall time
    decode_steps: int          # steps timed inside decode_s

    @property
    def per_step_s(self) -> float:
        """Mean decode-step wall time (0 for single-token generations)."""
        if self.decode_steps == 0:
            return 0.0
        return self.decode_s / self.decode_steps


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class DecodeEngine:
    """Prefill + layer-loop greedy decode for one ModelConfig."""

    def __init__(self, cfg: ModelConfig, *, max_batch: int = 4,
                 prompt_len: int = 16, max_gen: int = 16,
                 dtype=torch.float32, seed: int = 0, engine: str = "auto",
                 attention_impl: str = "registry",
                 params: Optional[lm.LM] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = dataclasses.replace(
            cfg, decode_attention_impl=attention_impl,
            decode_attention_engine=engine)
        lm.check_family(self.cfg)
        self.engine = engine
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.max_gen = max_gen
        self.dtype = dtype
        if params is None:
            params = lm.init_params(self.cfg, seed=seed, device=self.device)
        # matmul weights in the compute dtype once, not at every use
        self.params = lm.cast_params(params, dtype)

    # -- core phases -------------------------------------------------------

    @property
    def flash_decode_layers(self) -> int:
        """Layers whose decode step launches the flash-decode op: every
        layer on the registry path; none for MLA, an SSM or the dense
        path; a hybrid's shared block once per super-block."""
        cfg = self.cfg
        if (cfg.use_mla or cfg.family == "ssm"
                or cfg.decode_attention_impl != "registry"):
            return 0
        if cfg.family == "hybrid":
            return cfg.n_layers // cfg.attn_every
        return cfg.n_layers

    @property
    def max_len(self) -> int:
        """The serving cache length every decode step attends over."""
        return self.prompt_len + self.max_gen

    def make_prompt_batch(self, batch: Optional[int] = None,
                          seed: int = 0) -> Dict:
        """A capacity-sized synthetic prompt batch on the engine's device."""
        return make_batch(self.cfg, batch or self.max_batch,
                          self.prompt_len, seed=seed, device=self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Any]:
        """Prompt pass: last-position logits + caches padded to max_len."""
        logits, caches = lm.prefill(self.params, self.cfg, batch,
                                    dtype=self.dtype)
        return logits, lm.pad_caches(caches, self.max_len)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches, index: int
                    ) -> Tuple[torch.Tensor, Any]:
        """One token for every sequence: (B,1) tokens -> (B,1,V) logits.

        ``caches`` is updated in place at position ``index``.
        """
        return lm.decode_step(self.params, self.cfg, tokens, caches,
                              int(index), dtype=self.dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- greedy generation -------------------------------------------------

    def generate(self, batch: Dict, gen: Optional[int] = None,
                 ) -> GenerationResult:
        """Greedy decode ``gen`` tokens with a prefill/decode wall split.

        The decode phase times ``gen - 1`` steps (the first token falls
        out of prefill's last-position logits).  Both phases end in
        ``torch.cuda.synchronize()``, so the split is honest about
        asynchronous launches; nothing inside the loop waits for the
        card (the cache index is a host int, argmax stays on the card).
        """
        gen = min(self.max_gen, gen or self.max_gen)
        t0 = time.perf_counter()
        logits, caches = self.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        self._sync()
        t1 = time.perf_counter()
        toks = [tok]
        steps = 0
        for i in range(self.prompt_len, self.prompt_len + gen - 1):
            logits, caches = self.decode_step(tok, caches, i)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            toks.append(tok)
            steps += 1
        self._sync()
        t2 = time.perf_counter()
        return GenerationResult(
            tokens=torch.cat(toks, dim=1),
            logits=logits[:, -1] if logits.ndim == 3 else logits,
            caches=caches, prefill_s=t1 - t0, decode_s=t2 - t1,
            decode_steps=steps)

    def warmup(self, batch: Optional[Dict] = None) -> None:
        """Build the kernels and warm the card outside any timed region:
        one two-token generation (prefill and one decode step)."""
        self.generate(batch if batch is not None
                      else self.make_prompt_batch(), gen=2)

    # -- checkpointable cache state ---------------------------------------

    @staticmethod
    def cache_state(caches: Any) -> Dict:
        """A snapshot of the caches (KV, SSM) as a plain nested dict of
        tensors.

        Every leaf is a copy: ``decode_step`` writes the caches in place,
        so a state taken at step t stays that of step t, as the
        reference's immutable arrays do.
        """
        def copy(tree):
            return {k: copy(v) if isinstance(v, dict) else v.clone()
                    for k, v in tree.items()}
        return copy(caches)

    def load_cache_state(self, template: Any, state: Dict) -> Any:
        """Re-adopt a restored cache dict (shape/dtype-checked), as a copy
        that later decode steps may write without touching ``state``."""
        flat_t, flat_s = _flatten(template), _flatten(state)
        if list(flat_t) != list(flat_s):
            raise ValueError(f"cache structure mismatch: {list(flat_t)} vs "
                             f"{list(flat_s)}")
        for a, b in zip(flat_t.values(), flat_s.values()):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"cache leaf mismatch: {tuple(a.shape)}/{a.dtype} vs "
                    f"{tuple(b.shape)}/{b.dtype}")
        return self.cache_state(state)

    # -- analytics ---------------------------------------------------------

    @property
    def dtype_bytes(self) -> int:
        return torch.finfo(self.dtype).bits // 8

    def verdict(self, cfg: Optional[ModelConfig] = None) -> ModelVerdict:
        """The per-op model-scale verdict at this engine's (B, S, dtype).

        ``cfg`` defaults to the engine's own config; a serving path may
        pass the full-size architecture while execution runs smaller.
        """
        return model_verdict(cfg or self.cfg, self.max_batch, self.max_len,
                             dtype_bytes=self.dtype_bytes)

    def traits(self, cfg: Optional[ModelConfig] = None):
        """Whole-step Eq. 2 traits (the record's analytic join fields)."""
        return step_traits(cfg or self.cfg, self.max_batch, self.max_len,
                           dtype_bytes=self.dtype_bytes)
