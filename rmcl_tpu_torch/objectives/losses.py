"""Shared loss primitives in fp32 (port of ``rmcl_tpu/objectives/losses.py``)."""

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


def cross_entropy_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                             ignore_index: int = -100):
    """Per-sample decomposition of ``cross_entropy``: (nll_sum, valid_count)
    per leading-dim sample, so that ``cross_entropy(...) == sum(nll_sum) /
    max(sum(valid_count), 1)`` and a row-masked batch loss recombines exactly
    (the ``_ps`` keys: the val loader's wrap-around padding rows contribute
    zero)."""
    valid = labels != ignore_index
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    dims = tuple(range(1, nll.dim()))
    nll = torch.where(valid, nll, 0.0)
    return ((nll.sum(dims) if dims else nll),
            (valid.sum(dims) if dims else valid).float())


def bce_rowsum_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample sum of the elementwise BCE terms: the VQA loss
    (``bce_with_logits(...) * n_labels``) is the row mean of this."""
    x, t = logits.float(), targets.float()
    loss = x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return loss.sum(tuple(range(1, loss.dim())))


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
