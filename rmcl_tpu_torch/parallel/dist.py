"""The process group and the training step's tensor collectives.

The semantic they keep: W ranks of b pairs each compute the step that one
process computes on the W * b pairs laid end to end in rank order, as the
JAX package's pjit step sees the global batch.  So:

  * every random draw of the step is made for the global batch from the
    step's generator, which is the same on every rank, and each rank keeps
    its own slice (``local_rows``);
  * a loss that divides by a count over the batch divides by the global
    count (``batch_mean``); a per-sample mean over equal b needs nothing;
  * a loss that couples samples (BarlowTwins' correlation, its BatchNorm
    statistics, the MoCo queue's enqueue) reads the rows of every rank
    (``gather_rows``) and computes the same global value on each rank;
  * the gradient is the mean over ranks, one explicit all-reduce per
    optimizer step (``all_reduce_grads``), as DDP's ``no_sync`` places it
    under gradient accumulation; the scalar metrics are the mean over ranks
    (``comm.reduce_over_ranks``).

The model is not wrapped in ``nn.parallel.DistributedDataParallel``: one step
runs many forwards (the key forward, PGD's and the greedy attack's gradient
passes, the scoring forwards, the views) before its one backward, and DDP's
reducer is built for one forward per backward.

Every function here acts whenever a process group is initialised, one rank
included (a one-rank NCCL group runs its collectives: an all-reduce of one
rank is a copy, a division by 1 exact), and is the identity without one.

On a ``(data, model)`` grid (``parallel/mesh.py``; tensor parallelism) "the
ranks" above are the data group's: the batch is split over the data ranks,
every coupling and the gradient mean run over the data group, and the m ranks
of a model group, which hold the same rows, compute the same couplings.
Without a grid the data group is the whole world.
"""

from __future__ import annotations

import datetime
import inspect
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from rmcl_tpu_torch.parallel import mesh
from rmcl_tpu_torch.parallel.comm import is_distributed
from rmcl_tpu_torch.parallel.sharding_rules import model_partial

# the gradient all-reduce's flat buckets: 2^24 elements (64 MiB in fp32)
BUCKET_ELEMS = 1 << 24


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> torch.device:
    """Join the process group of the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` by default (made the
    current device), the CPU for ``device="cpu"``.  The backend is NCCL for a
    CUDA device and gloo for the CPU; a failure to initialise raises, and
    nothing falls back to another backend or device.  ``backend="gloo"`` on
    a CUDA device is the one explicit exception, for ranks that share one
    card (NCCL refuses two ranks on one device): gloo then reduces the CUDA
    tensors itself.  ``timeout_s`` bounds every collective's wait."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if device is None or torch.device(device) == torch.device("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: each rank trains on its card "
                               "(cuda:LOCAL_RANK); pass device='cpu' for gloo on the CPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if is_distributed():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is initialised "
                               f"already; asked for {backend}")
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, init_method="env://", rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl" and "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = device            # NCCL's communicator made now, failing now
    dist.init_process_group(**kw)
    return device


def destroy() -> None:
    """Leave the process group, when there is one, and the grid."""
    mesh.reset()
    if is_distributed():
        dist.destroy_process_group()


# ------------------------------------------------------------- the batch
def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of a global-batch tensor along ``dim``: the
    ``rank``-th of ``world`` equal parts, over the data group (the rows of
    one-process step that this rank's b pairs are)."""
    rank, world = mesh.data_rank(), mesh.data_size()
    if world == 1:
        return x
    n = x.shape[dim] // world
    if n * world != x.shape[dim]:
        raise ValueError(f"{x.shape[dim]} rows do not split into {world} equal parts")
    return x.narrow(dim, rank * n, n)


class _GatherRows(torch.autograd.Function):
    """Rows of every rank, in rank order.  Backward: this rank's rows of the
    incoming gradient times the world size, the sum over ranks of the same
    global loss's gradient (every rank computes the same loss from the same
    gathered rows), so that the mean over ranks of the parameters' gradients
    is the one-process gradient."""

    @staticmethod
    def forward(ctx, x):
        rank, world = mesh.data_rank(), mesh.data_size()
        ctx.rank, ctx.world, ctx.n = rank, world, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=mesh.data_group())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.rank * ctx.n, ctx.n) * ctx.world


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(W * b, ...) from every rank's (b, ...), in rank order; differentiable
    (``_GatherRows``); ``x`` itself without a process group.  Every rank
    must pass the same b."""
    if not is_distributed():
        return x
    return _GatherRows.apply(x)


def global_batch(b: int) -> int:
    """The global batch of ranks of ``b`` pairs each."""
    return b * mesh.data_size()


def batch_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)`` with ``count`` the global batch's: this
    rank's part W * total / max(sum of counts, 1), whose mean over ranks is
    the global sum over the global count (a count over the batch, unlike a
    per-sample mean, differs from rank to rank)."""
    if not is_distributed():
        return total / count.clamp(min=1)
    c = count.detach().to(torch.float32).clone()
    dist.all_reduce(c, group=mesh.data_group())
    return total * mesh.data_size() / c.clamp(min=1)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks (a new tensor; ``x`` without a process
    group)."""
    if not is_distributed():
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.data_group())
    return x


# ------------------------------------------------------------ gradients
def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive runs of ``tensors`` of one dtype and device, each at most
    BUCKET_ELEMS elements (a larger tensor alone)."""
    run: List[torch.Tensor] = []
    n = 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or n + t.numel() > BUCKET_ELEMS):
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def _reduce_buckets(grads: List[torch.Tensor], group, divide: int) -> None:
    for run in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat, group=group)
        if divide != 1:
            flat /= divide
        torch._foreach_copy_(run, [c.view_as(g) for c, g in zip(
            flat.split([g.numel() for g in run]), run)])


def partial_params(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters whose gradients are partial sums over the model group
    (``sharding_rules.model_partial``); none without a model axis."""
    if mesh.model_size() == 1:
        return []
    return [p for n, p in model.named_parameters() if model_partial(n)]


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     partial: Iterable[torch.nn.Parameter] = ()) -> None:
    """The mean over the data ranks of every parameter's ``.grad``, in place:
    flat buckets in the order of ``params`` (``model.parameters()``'s, the same
    on every rank), each summed by one all-reduce over the data group and
    divided by its size.  The ``partial`` parameters (``partial_params``) are
    first summed over the model group, in buckets of their own: after it a
    replicated parameter's gradient is the same bits on every rank of a model
    group.  A parameter without a gradient is skipped (the step gives each
    trainable one a gradient)."""
    if not is_distributed():
        return
    params = list(params)
    part = {id(p) for p in partial}
    if part:
        _reduce_buckets([p.grad for p in params if p.grad is not None and id(p) in part],
                        mesh.model_group(), 1)
    _reduce_buckets([p.grad for p in params if p.grad is not None], mesh.data_group(),
                    mesh.data_size())
