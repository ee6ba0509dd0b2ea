"""Plain PyTorch oracle for single-token (decode) GQA attention."""
from __future__ import annotations

import torch

#: The reference's mask value (not -inf: see ``flash_decode``).
NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: int) -> torch.Tensor:
    """q: (B, KH, G, Dh); k,v: (B, S, KH, Dh); attend to the first kv_len.

    Dense softmax in float32.  Returns (B, KH, G, Dh) in q's dtype."""
    scale = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(q.shape[-1])))
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * \
        scale.to(q.device)
    mask = torch.arange(k.shape[1], device=k.device) < kv_len
    s = torch.where(mask[None, None, None], s,
                    torch.tensor(NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", w, v.float()).to(q.dtype)
