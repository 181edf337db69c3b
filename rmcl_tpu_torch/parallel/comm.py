"""Host-level collectives (port of ``rmcl_tpu/parallel/comm.py``; reference
vilt/modules/dist_utils.py).

Arbitrary picklable objects travel as byte tensors, each rank's padded to
the longest, as the reference and the JAX package send them; the tensors
lie on the process group's device (the rank's CUDA device under NCCL, the
CPU under gloo).  Every function is the identity when no process group is
initialised or it has one rank, so the same code runs in one process.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """A process group is initialised (one rank included)."""
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """reference dist_utils.py:23-28"""
    return dist.get_world_size() if is_distributed() else 1


def get_rank() -> int:
    """reference dist_utils.py:31-36"""
    return dist.get_rank() if is_distributed() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def comm_device() -> torch.device:
    """The device the process group's tensors lie on: this rank's CUDA
    device under NCCL, the CPU otherwise."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def synchronize() -> None:
    """Barrier across processes (reference dist_utils.py:69-81)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every rank's picklable ``data``, in rank order (reference
    dist_utils.py:144-180): pickle -> uint8 tensor, the sizes gathered, each
    payload padded to the largest and gathered."""
    world = get_world_size()
    if world == 1:
        return [data]
    dev = comm_device()
    payload = torch.from_numpy(np.frombuffer(pickle.dumps(data), np.uint8).copy()).to(dev)
    size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    sizes = [int(s.item()) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[:payload.numel()] = payload
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return [pickle.loads(p[:n].cpu().numpy().tobytes()) for p, n in zip(parts, sizes)]


def gather(data: Any, dst: int = 0) -> List[Any]:
    """reference dist_utils.py:183-224: every rank's ``data`` on rank ``dst``
    (others get []).  As in the JAX package every rank pays the all-gather:
    the payloads are small eval artifacts."""
    out = all_gather(data)
    return out if get_rank() == dst else []


def reduce_over_ranks(values: Dict[str, torch.Tensor], average: bool = True,
                      group=None) -> Dict[str, torch.Tensor]:
    """Each 0-d tensor of ``values`` summed over the ranks of ``group`` (the
    default: all of them) in one all-reduce, and divided by their number
    when ``average`` (the sum, then / W: the same on every backend), in
    float64 where a value is float64 and in float32 otherwise; each returned
    in its own dtype.  It acts whenever a process group is initialised, one
    rank included, and returns ``values`` without one.  The tensors lie on
    one device the backend reduces (under NCCL, this rank's card)."""
    if not is_distributed() or not values:
        return values
    keys = list(values)
    wide = (torch.float64 if any(v.dtype == torch.float64 for v in values.values())
            else torch.float32)
    flat = torch.stack([values[k].detach().to(wide) for k in keys])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= dist.get_world_size(group)
    return {k: v.to(values[k].dtype) for k, v in zip(keys, flat.unbind())}


def reduce_dict(d: Dict[str, Any], average: bool = True) -> Dict[str, float]:
    """The per-key sum (or mean) of scalar dicts across ranks, in float64
    (reference dist_utils.py:241-270; ``reduce_over_ranks`` on floats)."""
    if get_world_size() == 1:
        return dict(d)
    dev = comm_device()
    out = reduce_over_ranks({k: torch.tensor(float(np.asarray(d[k])), dtype=torch.float64,
                                             device=dev) for k in sorted(d)}, average)
    return {k: v.item() for k, v in out.items()}


def shared_random_seed() -> int:
    """One seed all ranks agree on, rank 0's draw (reference
    dist_utils.py:227-238)."""
    return int(all_gather(int(np.random.randint(2 ** 31)))[0])
