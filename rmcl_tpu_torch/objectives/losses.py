"""Shared loss primitives in fp32 (port of ``rmcl_tpu/objectives/losses.py``:
the three that the PGD attacks use, and the cosine similarity of the
BarlowTwins views' diagnostics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over positions whose label != ignore_index (0 when there is
    none), in fp32."""
    valid = labels != ignore_index
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in fp32:
    max(x, 0) - x t + log(1 + exp(-|x|))."""
    x, t = logits.float(), targets.float()
    return (x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(|x|_2, eps) in fp32, cast back (``F.normalize`` semantics)."""
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return (x32 / n.clamp(min=eps)).to(x.dtype)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-6) -> torch.Tensor:
    """``nn.CosineSimilarity`` semantics in fp32: each norm clamped below at
    eps."""
    a32, b32 = a.float(), b.float()
    na = torch.linalg.vector_norm(a32, dim=dim).clamp(min=eps)
    nb = torch.linalg.vector_norm(b32, dim=dim).clamp(min=eps)
    return (a32 * b32).sum(dim) / (na * nb)
