"""NN primitives (port of ``rmcl_tpu/models/layers.py``).

Parameters are fp32 masters in torch layouts: a linear weight is (out, in).
``linear`` casts them to the activation type at use, LayerNorm runs in fp32
whatever the activation type, GELU is the exact-erf form.  Initialisation
follows the reference's ``init_weights``: truncated normal (std 0.02, cut at
two std) for linear and embedding weights, zero biases, LayerNorm 1 and 0.
``dropout`` applies an explicit keep mask: the masks of the whole model come
from one Philox stream (``ops/philox.py``), the blocks' inside their kernels.
``batch_norm`` is BatchNorm1d as a pure function, as the JAX package has it:
it returns the new running statistics and never writes them; the module
``BatchNorm1d`` keeps them as buffers and writes them only when asked.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

INIT_STD = 0.02


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = INIT_STD) -> torch.Tensor:
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ weight.to(x.dtype).t()
    return y if bias is None else y + bias.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 whatever the activation type, rounded back."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


gelu = F.gelu   # exact erf form, as torch.nn.GELU's default


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
               weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
               training: bool = True, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm1d over (B, C) in fp32, the result cast back to ``x.dtype``.
    Returns (y, new_mean, new_var).  Training normalises with the batch's
    mean and biased variance and moves the statistics by ``momentum`` towards
    the mean and the unbiased variance ``var * n / (n - 1)``; otherwise it
    normalises with the running statistics and returns them unchanged."""
    x32 = x.float()
    if training:
        mean = x32.mean(0)
        var = ((x32 - mean) ** 2).mean(0)
        n = x.shape[0]
        new_mean = (1 - momentum) * running_mean + momentum * mean.detach()
        new_var = (1 - momentum) * running_var + momentum * (var.detach() * n / max(n - 1, 1))
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y.to(x.dtype), new_mean, new_var


def dropout(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout on an explicit boolean keep mask:
    keep ? x / (1 - p) : 0, computed in fp32 and cast back."""
    return torch.where(keep, x.float() * (1.0 / (1.0 - p)), 0.0).to(x.dtype)


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class BatchNorm1d(nn.Module):
    """BatchNorm1d with ``running_mean`` / ``running_var`` as buffers (and
    ``weight`` / ``bias`` when ``affine``).  ``forward(x, training, update)``:
    the buffers change only when ``training`` and ``update`` are both set,
    so that an attack's training-mode forward leaves them as they were.  Over
    several processes BarlowTwins' callers hand the head every rank's rows
    (``parallel/dist.py:gather_rows``): the statistics are the global
    batch's, and the running statistics move alike on every rank."""

    def __init__(self, dim: int, affine: bool = True, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(dim)) if affine else None
        self.bias = nn.Parameter(torch.empty(dim)) if affine else None
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, training: bool = True,
                update: bool = False) -> torch.Tensor:
        y, mean, var = batch_norm(x, self.running_mean, self.running_var, self.weight,
                                  self.bias, training, self.momentum, self.eps)
        if training and update:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def reset_all(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every submodule that defines ``reset_parameters(generator)``,
    in module order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
