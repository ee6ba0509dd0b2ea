"""Model layer: the dense GQA, MoE, MLA, SSM and hybrid LM families over
the port's kernel stack.

* :mod:`repro_torch.models.config` — the reference's frozen
  :class:`ModelConfig` schema (copied, pure Python), and
  the settings it lacks in subclasses named for their feature:
  :class:`ExpertShareConfig` (a share of a group-limited gate's experts),
  :class:`YarnRopeConfig` (YaRN, the (even, odd) rope layout), and
  :class:`DeepSeekV2Config`, which takes both.
* :mod:`repro_torch.models.lm` — one module per layer and a Python layer
  loop: forward / prefill / decode_step for the dense, MoE, SSM and
  hybrid families (the hybrid: SSM super-blocks, one shared attention
  block after each).
* :mod:`repro_torch.models.moe` — the GShard top-k MoE FFN with per-group
  capacity, shared experts and the aux / z losses; and the expert share
  (``share_ffn``): the group-limited gate over every expert, the held
  experts' part computed dropless over their routed rows only.
* :mod:`repro_torch.models.ssm` — the Mamba2 (SSD) layer: chunked prefill,
  recurrent single-token decode, plain PyTorch as in the reference.
* :mod:`repro_torch.models.attention` — GQA attention and MLA (prefill
  decompressed, decode absorbed into latent space).
* :mod:`repro_torch.models.engine` — the :class:`DecodeEngine` serving
  entry point: prefill + greedy decode with every GQA layer's decode
  attention (a hybrid's shared block's too) through the hand-written
  flash-decode kernel, and a measured prefill/decode phase split.
* :mod:`repro_torch.models.advisor_map` — per-op Eq. 2 traits for one
  decode step and the model-scale verdict.
"""
from .advisor_map import (ModelVerdict, OpVerdict, decode_op_traits,
                          model_verdict, step_traits, verdict_payload)
from .config import (DeepSeekV2Config, ExpertShareConfig, ModelConfig,
                     YarnRopeConfig)
from .engine import DecodeEngine, GenerationResult

__all__ = [
    "DecodeEngine", "DeepSeekV2Config", "ExpertShareConfig",
    "GenerationResult", "ModelConfig", "ModelVerdict", "OpVerdict",
    "YarnRopeConfig", "decode_op_traits", "model_verdict", "step_traits",
    "verdict_payload",
]
