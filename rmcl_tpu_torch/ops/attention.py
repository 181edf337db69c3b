"""Plain masked multi-head self-attention (port of ``rmcl_tpu/ops/attention.py:mha_xla``).

Scores are q . k^T * scale in fp32, keys with mask == 0 get a -1e30 bias
(a finite sentinel: a fully masked row stays finite), softmax in fp32, and
the probabilities are rounded to v's type before P . V, which accumulates in
fp32.  This is the reference the attention kernel is held against.
"""

from __future__ import annotations

import torch

NEG_BIAS = -1e30


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
        scale: float) -> torch.Tensor:
    """q, k, v: (B, H, S, D); mask: (B, S), 1 = valid key.  Returns (B, H, S, D)."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG_BIAS)
    probs = torch.softmax(scores + bias, dim=-1)
    out = probs.to(v.dtype).float() @ v.float()
    return out.to(v.dtype)
