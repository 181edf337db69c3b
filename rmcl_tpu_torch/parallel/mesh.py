"""The ``(data, model)`` process grid over the torchrun world (counterpart of
``rmcl_tpu/parallel/mesh.py``).

The JAX package lays its devices out as ``np.reshape(devices, mesh_shape)``
under ``mesh_axis_names``; here the W ranks of the process group take that
place: rank ``data_index * m + model_index`` on a ``(data, model)`` grid of d
x m, ``cfg.mesh_shape`` / ``cfg.mesh_axis_names`` giving its shape.  Each rank
belongs to two groups, made with ``torch.distributed.new_group`` in the same
order on every rank:

  * its **data group**, the d ranks of its model index: the batch is split
    over it, and the step's couplings (``parallel/dist.py``) and the gradient
    mean run over it;
  * its **model group**, the m ranks of its data index: the transformer's
    matrices and the MLM decoder are sharded over it
    (``parallel/sharding_rules.py``), and the Megatron collectives
    (``parallel/tp.py``) run over it.

``init_grid`` builds the grid and makes it the active one; the collectives
read ``active()``.  Without a call the active grid is the 1-D one that data
parallelism uses: every rank a data rank, the data group the whole world (the
default group), the model group a rank alone.  A one-rank model group is the
identity: nothing is sharded and no model collective runs.  As in the JAX
package the ``Trainer`` keeps the 1-D grid whatever ``mesh_shape`` says.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from rmcl_tpu_torch.parallel.comm import get_rank, get_world_size

DATA_AXIS, MODEL_AXIS = "data", "model"


@dataclasses.dataclass(frozen=True)
class Grid:
    """A d x m grid; ``data_group`` / ``model_group`` are process groups, or
    None for the default group (the data group of the 1-D grid) and for a
    one-rank model group."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None


_active: Optional[Grid] = None


def _data_only() -> Grid:
    return Grid(data=get_world_size(), model=1, data_rank=get_rank(), model_rank=0)


def active() -> Grid:
    """The grid the collectives run over: ``init_grid``'s, else the 1-D one."""
    return _active if _active is not None else _data_only()


def reset() -> None:
    """Back to the 1-D grid (``parallel/dist.py:destroy`` calls it)."""
    global _active
    _active = None


def init_grid(shape: Sequence[int] = (1,),
              axis_names: Sequence[str] = (DATA_AXIS,)) -> Grid:
    """The grid of ``shape`` over the axes ``axis_names`` ("data" and, for
    tensor parallelism, "model", in either order), laid over the ranks as
    ``np.reshape(range(W), shape)``, made the active grid.  Raises when the
    shape's product is not the world size or an axis is neither."""
    global _active
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names) or \
            not set(names) <= {DATA_AXIS, MODEL_AXIS} or DATA_AXIS not in names:
        raise ValueError(f"mesh axes {names} of shape {shape}: the grid takes a 'data' "
                         "axis and, optionally, a 'model' axis")
    world = get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))} ranks; "
                         f"the process group has {world}")
    ranks = np.arange(world).reshape(shape)
    ia = names.index(DATA_AXIS)
    im = names.index(MODEL_AXIS) if MODEL_AXIS in names else None
    d = shape[ia]
    m = shape[im] if im is not None else 1
    # (m, d): row j the data group of model index j; its transpose, row i the
    # model group of data index i
    by_model = (np.moveaxis(ranks, ia, -1).reshape(m, d) if im is not None
                else ranks.reshape(1, d))
    rank = get_rank()
    j, i = (int(v[0]) for v in np.nonzero(by_model == rank))
    data_group = model_group = None
    if m > 1:
        # every rank makes every group, in the same order (new_group's rule)
        for row in by_model:
            g = dist.new_group(row.tolist())
            if rank in row:
                data_group = g
        for col in by_model.T:
            g = dist.new_group(col.tolist())
            if rank in col:
                model_group = g
    _active = Grid(data=d, model=m, data_rank=i, model_rank=j,
                   data_group=data_group, model_group=model_group)
    return _active


def data_rank() -> int:
    return active().data_rank


def data_size() -> int:
    return active().data


def model_rank() -> int:
    return active().model_rank


def model_size() -> int:
    return active().model


def data_group():
    return active().data_group


def model_group():
    return active().model_group
