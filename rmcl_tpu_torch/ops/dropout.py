"""Inverted dropout outside the block kernels, on the Philox stream of the
training kernels.

The JAX package applies ``layers.dropout`` (XLA) wherever a block's dropout
does not run inside a Pallas kernel: after the embeddings, after the unfused
block's proj, and in the plain MLP.  Here ``dropout(x, seeds, draw, p)`` draws
the mask of element (sample b, row r, column c) of x (B, S, N) from
``seeds[b]``, ``draw``, r and c (``ops/philox.py``), the function the
kernels' epilogues evaluate.  The block uses their convention, so every block
configuration computes the same function from the same seeds:

  * after proj:                   ``seeds[0]``, draw 0, S x C
  * inside the MLP, after GELU:   ``seeds[1]``, draw 0, S x 4C
  * the MLP tail, after fc2:      ``seeds[1]``, draw 1, S x C

``col0`` shifts the mask's columns (``ops/philox.py``): x's column c draws the
word of column ``col0 + c``, as a tensor-parallel shard of the MLP's hidden
columns does.

Both directions are ``keep ? x / (1 - p) : 0`` in fp32, rounded once.  On a
CUDA tensor the forward and the backward launch the ``drop_scale`` kernel of
``csrc/block_kernels.cu`` (the one the training attention backward uses for
its masked cotangent), counted in ``fused_block.launches["dropout"]``; on a
CPU tensor they run ``philox.keep_mask`` and ``layers.dropout``, which give
the same bits.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from rmcl_tpu_torch.models.layers import dropout as dropout_plain
from rmcl_tpu_torch.ops import _build
from rmcl_tpu_torch.ops.fused_block import _check, launches
from rmcl_tpu_torch.ops.fused_block_train import _drop_scale
from rmcl_tpu_torch.ops.philox import check_rate, keep_mask


def _apply(x, seeds, draw: int, p: float, col0: int = 0):
    B, S, N = x.shape
    if x.device.type == "cpu":
        return dropout_plain(x, keep_mask(seeds, draw, S, N, p, col0), p)
    x = x.contiguous()
    _check(x, dict(x=x, seeds=seeds), dict(x=(B, S, N), seeds=(B,)))
    out = _drop_scale(_build.library(), x.view(B * S, N), (seeds, S, draw, p, None, col0))
    launches["dropout"] += 1
    return out.view(B, S, N)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seeds, draw, p, col0):
        ctx.save_for_backward(seeds)
        ctx.conf = (draw, p, col0)
        return _apply(x, seeds, draw, p, col0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        seeds, = ctx.saved_tensors
        return _apply(g, seeds, *ctx.conf), None, None, None, None


def dropout(x: torch.Tensor, seeds: torch.Tensor, draw: int, p: float,
            col0: int = 0) -> torch.Tensor:
    """Inverted dropout of x (B, S, N) at rate p with mask ``draw`` of the
    per-sample streams ``seeds`` (B,) int32, at the mask's columns ``col0`` ..
    ``col0 + N - 1``; x itself at p = 0."""
    check_rate(p)
    if p == 0.0:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Dropout.apply(x, seeds, draw, p, col0)
    return _apply(x, seeds, draw, p, col0)
