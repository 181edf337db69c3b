"""The model-group collectives of Megatron tensor parallelism (Shoeybi et al.,
"Megatron-LM", 2019: its f and g), as autograd functions over the active
grid's model group (``parallel/mesh.py``).

  * ``copy_to_model`` (f): the identity forward; the backward sums the input
    gradient over the model group.  It stands before a column-parallel
    product, whose shards each give a partial gradient of the replicated
    input.
  * ``reduce_from_model`` (g): the forward sums the shards' partial outputs
    over the model group; the backward passes the gradient through.  It
    stands after a row-parallel product.
  * ``gather_from_model``: the shards' column blocks, concatenated along the
    last dimension in model-rank order; the backward keeps this rank's
    block.  The MLM decoder's vocabulary-parallel logits go through it, so
    that the loss is computed on the full logits, the same on every rank.

Every sum is one all-reduce in the tensor's own type; with a one-rank model
group each function returns its input untouched.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rmcl_tpu_torch.parallel import mesh


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=mesh.model_group())
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _gather(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.model_size())]
    dist.all_gather(parts, x, group=mesh.model_group())
    return torch.cat(parts, dim=-1)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.n = mesh.model_rank(), x.shape[-1]
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous()


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f: ``x``; its gradient summed over the model group."""
    if mesh.model_size() == 1:
        return x
    return _CopyToModel.apply(x) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """g: ``x`` summed over the model group; the gradient passed through."""
    if mesh.model_size() == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x)
    return _all_reduce(x)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model group's (..., n) blocks as (..., m * n), in model-rank order;
    the gradient of this rank's block is its block of the incoming one."""
    if mesh.model_size() == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromModel.apply(x)
    return _gather(x)
