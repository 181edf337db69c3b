"""Optimizer and LR schedule (port of ``rmcl_tpu/train/schedule.py``;
reference vilt/modules/vilt_utils.py:331-437).

Four parameter groups, (with / without weight decay) x (base / head learning
rate), chosen from each parameter's dotted name by the JAX package's rules:
no decay for biases and for anything under a name containing ``norm`` or
``LayerNorm``; the head multiplier ``lr_mult`` for ``vqa_classifier``,
``nlvr2_classifier`` and ``moco_head`` (the reference's list names
``barlowtwinshead``, which matches no module, so that head trains at the
base rate: mirrored by leaving it out); the momentum twins ``k_*`` frozen
(BatchNorm running statistics, frozen leaves of the JAX pytree, are buffers
here and never reach the optimizer).
Schedules follow HuggingFace ``get_polynomial_decay_schedule_with_warmup`` /
``get_cosine_schedule_with_warmup``: the rate is 0 at step 0 under warmup.

The optimizer follows ``cfg.optim_type`` as the JAX package's optax
transforms do, per group:

  * ``adamw``: ``torch.optim.AdamW`` (betas 0.9 / 0.98, eps 1e-8).  optax's
    ``adamw`` adds ``weight_decay * p`` to the Adam direction and scales the
    sum by the rate; torch's shrinks ``p`` by ``lr * weight_decay`` and then
    takes the Adam step: the same update.
  * ``adam``: ``torch.optim.Adam`` with optax's defaults (betas 0.9 /
    0.999, eps 1e-8) and no weight decay, as ``optax.adam``.
  * ``sgd``: ``torch.optim.SGD`` with momentum 0.9 and no weight decay, as
    ``optax.sgd(momentum=0.9)``: the trace ``g + 0.9 * trace`` times the
    rate.

All index the schedule by the number of updates already made.  Gradient
accumulation (optax ``MultiSteps``) is the training step's
(``train/step.py``): it hands the optimizer the mean gradient once per cycle.
``cfg.zero1`` shards the optimizer's state over the processes (ZeRO-1).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from rmcl_tpu_torch.parallel import mesh
from rmcl_tpu_torch.parallel.comm import is_distributed
from rmcl_tpu_torch.parallel.sharding_rules import check_zero1

NO_DECAY_SUBSTRINGS = ("norm", "LayerNorm")  # + leaf name "bias"
HEAD_NAMES = ("vqa_classifier", "nlvr2_classifier", "moco_head")

BASE_DECAY = "base_decay"
BASE_NO_DECAY = "base_no_decay"
HEAD_DECAY = "head_decay"
HEAD_NO_DECAY = "head_no_decay"
FROZEN = "frozen"


def _label_for(name: str) -> str:
    """Group label of a parameter from its dotted state_dict name."""
    names = name.split(".")
    if names[0].startswith("k_"):
        return FROZEN
    is_head = any(any(h in n for h in HEAD_NAMES) for n in names)
    no_decay = (names[-1] == "bias"
                or any(any(s in n for s in NO_DECAY_SUBSTRINGS) for n in names))
    if is_head:
        return HEAD_NO_DECAY if no_decay else HEAD_DECAY
    return BASE_NO_DECAY if no_decay else BASE_DECAY


def param_group_labels(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: group label} over ``model.named_parameters()``."""
    return {name: _label_for(name) for name, _ in model.named_parameters()}


# ------------------------------------------------------------- schedules
def make_lr_schedule(cfg, max_steps: int, lr: float = None) -> Callable[[int], float]:
    """HF-compatible warmup + (polynomial | cosine) decay: step -> rate."""
    base_lr = cfg.learning_rate if lr is None else lr
    warmup = cfg.warmup_steps
    if isinstance(warmup, float):
        warmup = int(max_steps * warmup)
    warmup = max(int(warmup), 0)
    span = max(max_steps - warmup, 1)

    if cfg.decay_power == "cosine":
        def sched(step):
            if step < warmup:
                return base_lr * step / max(warmup, 1)
            progress = (step - warmup) / span
            return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
        return sched

    power = float(cfg.decay_power)
    lr_end = cfg.end_lr

    def sched(step):
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        remaining = min(max(1.0 - (step - warmup) / span, 0.0), 1.0)
        return (base_lr - lr_end) * remaining ** power + lr_end
    return sched


# ------------------------------------------------------------- optimizer
def make_optimizer(cfg, model: torch.nn.Module, max_steps: int
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR,
                              Dict[str, str]]:
    """(optimizer, scheduler, labels).  One group per non-empty label;
    frozen parameters are in none.  Call ``scheduler.step()`` after every
    ``optimizer.step()``.  ``cfg.zero1`` over several processes: the same
    optimizer as a ``ZeroRedundancyOptimizer`` (PARITY #24), each rank
    keeping the state of its shard of the parameters and broadcasting their
    update, which is the replicated optimizer's bit for bit; in one process
    there is nothing to shard and the optimizer is the plain one.  On a grid
    with a model axis ``cfg.zero1`` raises."""
    if cfg.optim_type not in ("adamw", "adam", "sgd"):
        raise ValueError(f"unknown optim_type {cfg.optim_type!r}")
    check_zero1(cfg, mesh.model_size())
    labels = param_group_labels(model)
    params = dict(model.named_parameters())
    wd = cfg.weight_decay if cfg.optim_type == "adamw" else 0.0
    groups, lambdas = [], []
    for label, lr_scale, decay in ((BASE_DECAY, 1.0, wd), (BASE_NO_DECAY, 1.0, 0.0),
                                   (HEAD_DECAY, cfg.lr_mult, wd),
                                   (HEAD_NO_DECAY, cfg.lr_mult, 0.0)):
        members = [params[n] for n, lab in labels.items() if lab == label]
        if members:
            # lr 1.0 x the schedule's own value: LambdaLR multiplies the two
            groups.append({"params": members, "lr": 1.0, "weight_decay": decay})
            lambdas.append(make_lr_schedule(cfg, max_steps,
                                            lr=cfg.learning_rate * lr_scale))
    kind, kw = {"adamw": (torch.optim.AdamW, dict(betas=(0.9, 0.98), eps=1e-8)),
                "adam": (torch.optim.Adam, dict(betas=(0.9, 0.999), eps=1e-8)),
                "sgd": (torch.optim.SGD, dict(momentum=0.9))}[cfg.optim_type]
    if cfg.zero1 and is_distributed():
        from torch.distributed.optim import ZeroRedundancyOptimizer
        optimizer = ZeroRedundancyOptimizer(groups, optimizer_class=kind, **kw)
    else:
        optimizer = kind(groups, **kw)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)
    return optimizer, scheduler, labels
