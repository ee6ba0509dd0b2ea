#!/usr/bin/env python3
"""Audit the flash-decode kernels and the models' decode steps on the card.

    python3 tools/decode_audit.py [--parts ptxas slots steps]

Three parts, each printing JSON lines with the card's name and power
limit (``--parts`` picks some, default all):

* ``ptxas``: prints, per kernel instantiation of ``csrc/attention.cu``
  (every head dim, both head tiles), its registers, shared memory, stack
  and spill bytes, from the ``-Xptxas -v`` report the build keeps
  (``_ext.ptxas_usage``);
* ``slots``: times flash-decode at Mistral-NeMo's (B 4, KH 8, G 4) and
  Qwen3-MoE's (B 4, KH 4, G 16) decode shapes over S = 32768, kv_len 7S/8,
  with the positions cut for 1, 2, 3 and 4 CTA slots per SM
  (``_ext.attention_split``), both dtypes and engines, CUDA-event median
  and IQR of 20 calls after 3 warm-ups: the evidence for
  ``_ext.ctas_per_sm``;
* ``steps``: for Mistral-NeMo-12B, DeepSeek-V2-Lite-16B,
  Qwen3-MoE-235B-A22B, SeamlessM4T-large-v2 and Qwen2-VL-72B at full
  width and 2 layers (3 for DeepSeek: its first is dense; SeamlessM4T's
  encoder 2 as well), batch 4, prompt 32 (Qwen2-VL: its 1024 patch
  positions and 32), float32 random weights from seed 0, counts the host
  synchronisations of one decode step (``torch.cuda.set_sync_debug_mode``)
  and the kernels it launches (``torch.profiler``), per layer.

Needs an NVIDIA card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARTS = ("ptxas", "slots", "steps")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_audit: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _ext
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False

    if "ptxas" in opts.parts:
        for entry in _ext.attention_kernel_usage():
            print(json.dumps({"part": "ptxas", **entry, "card": card}),
                  flush=True)

    if "slots" in opts.parts:
        from repro_torch.core.timing import time_fn
        _ext.build(("attention",))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, dh, s = 4, 128, 32768
        kv_len = s - s // 8
        for kh, g in ((8, 4), (4, 16)):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(shape, generator=gen,
                                       device="cuda").to(dtype)
                           for shape in ((b, kh, g, dh), (b, s, kh, dh),
                                         (b, s, kh, dh)))
                for per_sm in (1, 2, 3, 4):
                    rows, nsplit = _ext.attention_split(
                        s, 512, b * kh, per_sm * sms, kv_len)
                    for engine in ("vector", "matrix"):
                        t = time_fn(lambda: _ext.attention_launch(
                            q, k, v, kv_len, rows=rows, nsplit=nsplit,
                            end=kv_len, engine=engine), warmup=3, iters=20)
                        print(json.dumps({
                            "part": "slots", "g": g, "kh": kh,
                            "dtype": str(dtype)[6:], "engine": engine,
                            "ctas_per_sm": per_sm, "rows": rows,
                            "nsplit": nsplit, "median_us": t.median_us,
                            "iqr_us": t.iqr_us,
                            "default": per_sm == _ext.ctas_per_sm(
                                dtype, g, engine), "card": card}),
                            flush=True)
                del q, k, v
                torch.cuda.empty_cache()

    if "steps" in opts.parts:
        from repro_torch.configs import get_arch
        from repro_torch.models.engine import DecodeEngine
        for name in ("mistral-nemo-12b", "deepseek-v2-lite-16b",
                     "qwen3-moe-235b-a22b", "seamless-m4t-large-v2",
                     "qwen2-vl-72b"):
            full = get_arch(name)
            cfg = dataclasses.replace(
                full, n_layers=2 + full.first_dense_layers,
                n_enc_layers=min(full.n_enc_layers, 2))
            at = 32 + cfg.frontend_len
            eng = DecodeEngine(cfg, max_batch=4, prompt_len=at, max_gen=4)
            logits, caches = eng.prefill(eng.make_prompt_batch())
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            eng.decode_step(tok, caches, at)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    eng.decode_step(tok, caches, at + 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = sum("synchronizing" in str(w.message) for w in caught)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                eng.decode_step(tok, caches, at + 2)
                torch.cuda.synchronize()
            kernels = sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            print(json.dumps({
                "part": "steps", "model": name, "layers": cfg.n_layers,
                "host_syncs_per_step": syncs,
                "kernels_per_step": kernels,
                "kernels_per_layer": kernels / cfg.n_layers,
                "card": card}), flush=True)
            del eng, caches, logits, prof
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
