"""The training step with task dispatch (port of ``rmcl_tpu/train/step.py``).

The JAX package compiles ``(TrainState, batch, rng) -> (TrainState,
metrics)`` as one program of pure functions.  The port runs eagerly and
updates in place: ``TrainState`` holds the live model (whose buffers are the
MoCo queue and its pointer), the optimizer and the scheduler, and
``train_step(batch, generator) -> metrics`` advances them.  One step of
``task_moco`` is, in order: the momentum update of the twins, the key
forward, the PGD image attack against the post-update parameters, the clean
and the attacked query views with dropout, the loss's backward, AdamW, the
enqueue of the keys.  The text attack's output enters through
``batch["attacked_text_ids"]`` / ``["attacked_text_masks"]``, as it does in
the JAX package's ``make_train_step``; ``make_attacked_train_step`` runs the
greedy text attack inside the step instead, after the key forward.

Every block of the key forward and of the attack runs its deterministic
forward and dx-only backward, every block of the four query views its
training forward and full backward, with the ops the block configuration
selects (``cfg.attention_impl`` / ``cfg.mlp_impl``, ``models/vit.py:Block``):
by default the fused halves (``ops/fused_block.py``,
``ops/fused_block_train.py``).  The block matrices in the compute type are
cast from the float32 master parameters once per optimizer step, after the
update (the twins': after the momentum update), never per call or per view;
the unfused block's training products take the masters themselves.

Gradient accumulation (``accum`` > 1, the reference's
``accumulate_grad_batches``; optax ``MultiSteps`` in the JAX package): the
step body runs per micro-batch, so the momentum update, the key forward, the
attacks and the enqueue advance on every call; the gradients are averaged as
``MultiSteps`` averages them (``acc + (g - acc) / (k + 1)`` at micro-step k)
and the optimizer applies the mean once per cycle.  ``ts.step`` counts
micro-batches; the ``lr`` metric is the rate of optimizer step
``ts.step // accum``.  ``make_eval_step`` is the deterministic forward of
every active task, with its attacks.

``task_barlowtwins`` runs the same way without the momentum update, the clean
view and the enqueue: the key forward through the query encoder, the PGD
against the correlation loss, the text, image and combined views.  Its head's
BatchNorm running statistics move in place at every head call of the step
(on every micro-step under accumulation), as the JAX step grafts them on
every call; the optimizer never sees them (they are buffers).

The downstream tasks (``objectives/downstream.py``): ``vqa``, ``nlvr2`` and
``irtr`` train on their clean forward; ``vqa_attacked``, ``nlvr2_attacked``
and ``irtr_attacked`` on the PGD image (when ``cfg.image_view``) and the
attacked text from ``attacked_text_ids`` (when ``cfg.text_view``), NLVR2 and
IRTR on the clean forward too.  Each training forward draws its own dropout
seeds (``task_seeds``); an attacked pass reuses its clean pass's.

The pretraining tasks (``objectives/pretrain.py``): ``mlm``, ``mpp``,
``mppd``, ``mpfr`` and ``itm`` (ITM with its word-patch alignment) each run
one training forward on its own dropout seeds.  Their random draws, the ITM
permutation and each masked-patch task's two masks, come from the step's CPU
generator on the host (``pretrain_draws``) and reach the device in one copy,
so that the card and the CPU draw the same from the same generator; the eval
step draws them from the generator it is given.

Over several processes (``parallel/dist.py``; the Trainer under torchrun)
each rank runs the step on its b pairs and the ranks together compute the
step of one process on the W * b pairs laid end to end in rank order, as the
JAX package's pjit step sees the global batch: the dropout seeds and the
pretraining draws are drawn for the global batch from the step's generator
(the same on every rank) and each rank keeps its slice; the objectives
couple the ranks where their loss couples the batch (the MoCo enqueue,
BarlowTwins' head and correlation, the pretraining tasks' global counts);
the gradient is averaged over ranks by one bucketed all-reduce per
optimizer step, after the accumulation cycle's running mean; the scalar
metrics are the global batch's (the mean over ranks).  ``cfg.zero1`` shards
the optimizer's state over the ranks (``train/schedule.py``).

Tensor parallelism (``parallel/mesh.py:init_grid`` on a ``(data, model)``
grid, ``cfg.mesh_shape`` / ``cfg.mesh_axis_names``): "the ranks" above are the
data ranks, each data rank's b pairs run on the m ranks of its model group,
and each of those holds its shards of the transformers and the MLM decoder
(``create_train_state``).  The gradient of a block's LayerNorms and
row-parallel biases is summed over the model group before the data mean
(``parallel/dist.py:all_reduce_grads``).  The ``Trainer`` keeps the 1-D grid,
as the JAX package's does.

Every task of the JAX package's ``compute_all_tasks`` is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from rmcl_tpu_torch.attacks.greedy import greedy_attack_extras, greedy_attack_framework
from rmcl_tpu_torch.attacks.greedy_fused import TABLE_KEYS, FusedGreedyAttack
from rmcl_tpu_torch.attacks.pgd import (make_pgd_barlowtwins, make_pgd_irtr, make_pgd_moco,
                                        make_pgd_nlvr2, make_pgd_vqa)
from rmcl_tpu_torch.core.config import active_tasks
from rmcl_tpu_torch.models.vilt import ViLT, draw_seeds
from rmcl_tpu_torch.models.vit import normalize_image_inputs
from rmcl_tpu_torch.objectives import contrastive, downstream, pretrain
from rmcl_tpu_torch.parallel import mesh
from rmcl_tpu_torch.parallel.comm import reduce_over_ranks
from rmcl_tpu_torch.parallel.dist import (all_reduce_grads, global_batch, local_rows,
                                          partial_params)
from rmcl_tpu_torch.parallel.sharding_rules import shard_model
from rmcl_tpu_torch.train.schedule import make_lr_schedule, make_optimizer

VIEWS = 4   # clean, txt, img, both: one set of dropout seeds each, per contrastive task
CONTRASTIVE = ("moco", "barlowtwins")
# the training forwards of a downstream task, one set of dropout seeds each:
# VQA one, NLVR2 one per image, IRTR one over the B * (F+1) rows
DOWNSTREAM_FORWARDS = {"vqa": 1, "vqa_attacked": 1, "nlvr2": 2, "nlvr2_attacked": 2,
                       "irtr": 1, "irtr_attacked": 1}
# the pretraining tasks, one training forward each, in the JAX package's order
PRETRAIN = ("mlm", "mpp", "mppd", "mpfr", "itm")
MASKED_PATCH = ("mpp", "mppd", "mpfr")
MPP_MASK_PROB, MPP_REPLACE_PROB = 0.15, 0.8


@dataclasses.dataclass
class TrainState:
    model: ViLT
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    # the query transformer's matrices in the compute type, recast after
    # every optimizer step
    block_matrices: Optional[List[Dict[str, torch.Tensor]]] = None
    # micro-batches per optimizer step; when > 1, acc_grads holds the running
    # mean of this cycle's micro-gradients, one per trainable parameter (zero
    # between cycles)
    accum: int = 1
    acc_grads: Optional[List[torch.Tensor]] = None

    def refresh_block_matrices(self) -> None:
        tr = self.model.transformer
        self.block_matrices = tr.block_matrices(self.model.compute_dtype)


def resolve_max_steps(cfg, steps_per_epoch: int = 1000) -> int:
    if cfg.max_steps:
        return int(cfg.max_steps)
    return int(cfg.max_epoch * steps_per_epoch)


def training_device(device=None) -> torch.device:
    """The first CUDA device, or what the caller asked for; without a card
    only an explicit ``device="cpu"`` runs (the plain ops)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or torch.cuda.is_available():
            return device
    elif torch.cuda.is_available():
        return torch.device("cuda", 0)
    raise RuntimeError("no CUDA device: the training step runs on a GPU; pass "
                       "device='cpu' to run the plain ops on the CPU")


def create_train_state(cfg, max_steps: Optional[int] = None,
                       model: Optional[ViLT] = None, device=None,
                       accum: int = 1) -> TrainState:
    """A ``TrainState`` on the training device.  ``model`` defaults to a
    ``ViLT`` initialised from ``cfg.seed``; the momentum twins are frozen
    (the momentum update moves them, never the optimizer).  ``max_steps``
    counts optimizer steps; ``accum`` > 1 keeps the accumulated gradients.
    Over several processes every rank builds the same state from the same
    seed (``cfg.zero1``: the optimizer's state sharded, ``make_optimizer``).
    On a grid with a model axis (``parallel/mesh.py:init_grid``) the full
    model, ``model`` or the seeded one, is cut to this model rank's shards
    (``parallel/sharding_rules.py:shard_model``): the shard is the same slice
    of the same weights on any grid, and the optimizer's state follows it."""
    device = training_device(device)
    if model is None:
        model = ViLT(cfg).init(torch.Generator().manual_seed(cfg.seed))
    m = mesh.model_size()
    if m > 1 and model.model_shards == 1:
        model = shard_model(cfg, model, mesh.model_rank(), m)
    elif model.model_shards != m:
        raise ValueError(f"a model of {model.model_shards} shards on a grid whose model "
                         f"axis has {m}")
    model = model.to(device).train()
    for name, p in model.named_parameters():
        if name.startswith("k_"):
            p.requires_grad_(False)
    optimizer, scheduler, _ = make_optimizer(cfg, model,
                                             max_steps or resolve_max_steps(cfg))
    ts = TrainState(model, optimizer, scheduler, accum=accum)
    if accum > 1:
        ts.acc_grads = [torch.zeros_like(p) for p in model.parameters() if p.requires_grad]
    ts.refresh_block_matrices()
    return ts


# ---------------------------------------------------------------- helpers
def _attacked_text_of(batch) -> Optional[Dict[str, torch.Tensor]]:
    if "attacked_text_ids" in batch:
        return {"text_ids": batch["attacked_text_ids"],
                "text_masks": batch["attacked_text_masks"]}
    return None


# canonical loss keys per task: the total loss is their sum (the reference
# sums every key containing "loss", which counts diagnostics twice)
_TASK_LOSS_KEYS = {
    "mlm": ("mlm_loss",),
    "mpp": ("mpp_loss",),
    "mppd": ("mppd_loss",),
    "mpfr": ("mpfr_loss",),
    "itm": ("itm_loss", "itm_wpa_loss"),
    "moco": ("moco_loss",),
    "barlowtwins": ("barlowtwins_loss",),
    "vqa": ("vqa_loss",),
    "nlvr2": ("nlvr2_loss",),
    "irtr": ("irtr_loss",),
    "vqa_attacked": ("vqa_attacked_loss",),
    "nlvr2_attacked": ("nlvr2_original_loss", "nlvr2_attacked_loss"),
    "irtr_attacked": ("irtr_original_loss", "irtr_attacked_loss"),
}


def task_seeds(cfg, generator: torch.Generator, num_layers: int, batch: int,
               device) -> Dict[str, torch.Tensor]:
    """The dropout seeds of one training step, per active task: ``VIEWS``
    sets for each contrastive task (drawn first, in ``CONTRASTIVE``'s order,
    as one tensor), then ``DOWNSTREAM_FORWARDS`` sets for each downstream
    task and one for each pretraining task, in the order of
    ``cfg.loss_names``, IRTR's over B * (F+1) rows.  Over several processes
    each set is drawn for the global batch and this rank keeps its rows."""
    tasks = active_tasks(cfg)
    out: Dict[str, torch.Tensor] = {}

    def draw(views, rows):
        s = draw_seeds(generator, views, num_layers, global_batch(rows), device)
        return local_rows(s, dim=-1).contiguous()

    cont = [t for t in CONTRASTIVE if t in tasks]
    if cont:
        s = draw(VIEWS * len(cont), batch)
        out.update({t: s[VIEWS * i:VIEWS * (i + 1)] for i, t in enumerate(cont)})
    for t in tasks:
        if t in DOWNSTREAM_FORWARDS:
            rows = batch * (cfg.draw_false_text + 1) if t.startswith("irtr") else batch
            out[t] = draw(DOWNSTREAM_FORWARDS[t], rows)
        elif t in PRETRAIN:
            out[t] = draw(1, batch)[0]
    return out


def pretrain_draws(cfg, generator: torch.Generator, batch: int, n_patches: int,
                   device) -> Dict[str, torch.Tensor]:
    """The random draws of the active pretraining tasks, in the order of
    ``cfg.loss_names``, from the CPU ``generator``, moved to ``device`` in one
    copy: for each masked-patch task (2, batch, n_patches) bool, MPP's
    Bernoulli masks over every patch (masked at 0.15; replaced by the mask
    token at 0.8 among the masked); for ``itm`` (batch,) int64, a random
    permutation of batch // 2 ones and batch - batch // 2 zeros (the true
    image where 1, ``false_image_0`` where 0).  Empty without such a task.
    Over several processes each draw is the global batch's and this rank
    keeps its rows."""
    parts: Dict[str, torch.Tensor] = {}
    n = global_batch(batch)
    for t in active_tasks(cfg):
        if t in MASKED_PATCH:
            masked = torch.rand(n, n_patches, generator=generator) < MPP_MASK_PROB
            keep = torch.rand(n, n_patches, generator=generator) < MPP_REPLACE_PROB
            parts[t] = local_rows(torch.stack([masked, keep & masked]), dim=1)
        elif t == "itm":
            base = torch.arange(n) < n // 2
            parts[t] = local_rows(base[torch.randperm(n, generator=generator)])
    if not parts:
        return {}
    flat = torch.cat([v.flatten() for v in parts.values()]).to(device)
    out = dict(zip(parts, (c.view(v.shape) for c, v in zip(
        flat.split([v.numel() for v in parts.values()]), parts.values()))))
    if "itm" in out:
        out["itm"] = out["itm"].long()
    return out


def _draws_for(cfg, generator: Optional[torch.Generator], batch, device):
    """``pretrain_draws`` for a step's batch, or {} when no pretraining task
    is active; such a task needs the generator."""
    if not any(t in PRETRAIN for t in active_tasks(cfg)):
        return {}
    if generator is None:
        raise ValueError("the pretraining tasks draw their ITM labels and MPP masks from a "
                         "generator: pass one")
    return pretrain_draws(cfg, generator, batch["text_ids"].shape[0],
                          batch["image"].shape[1], device)


def _build_pgd(cfg, ts: TrainState, task: str) -> Callable:
    """The PGD image attack of a downstream task on the step's matrices."""
    a, model = cfg, ts.model
    if task == "nlvr2_attacked":
        attack = make_pgd_nlvr2(model, a.adv_steps_img, a.adv_lr_img, a.adv_max_norm_img,
                                a.attack_idx)
    elif task == "vqa_attacked":
        attack = make_pgd_vqa(model, a.adv_steps_img, a.adv_lr_img, a.adv_max_norm_img,
                              a.vqav2_label_size)
    else:
        attack = make_pgd_irtr(model, a.adv_steps_img, a.adv_lr_img, a.adv_max_norm_img,
                               a.temperature)
    return lambda b, *target: attack(b, *target, block_matrices=ts.block_matrices)


def compute_all_tasks(cfg, ts: TrainState, batch, seeds, *, train: bool,
                      greedy_fn: Optional[Callable] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None):
    """Run every active task (reference forward vilt_module.py:420-469).
    Returns (total_loss, ret).  Twins, queue and BatchNorm running statistics
    are updated in place.  ``seeds``: ``task_seeds``'s dict (None when not
    ``train``).  ``greedy_fn``: the text attack inside a contrastive task's
    step (``objectives/contrastive.py``).  ``draws``: ``pretrain_draws``'s
    dict, for the pretraining tasks."""
    tasks = active_tasks(cfg)
    other = [t for t in tasks if t not in _TASK_LOSS_KEYS]
    if other:
        raise ValueError(f"unknown tasks {other}")
    model = ts.model
    # u8 wire format -> f32 once, every image key with its own _hw
    batch = normalize_image_inputs(batch, model.grid_hw, model.patch_size)
    seeds, draws = seeds or {}, draws or {}
    ret: Dict[str, torch.Tensor] = {}
    pre = dict(block_matrices=ts.block_matrices, train=train)
    if "mlm" in tasks:
        ret.update(pretrain.compute_mlm(model, batch, seeds=seeds.get("mlm"), **pre))
    for t, fn in (("mpp", pretrain.compute_mpp), ("mppd", pretrain.compute_mppd),
                  ("mpfr", pretrain.compute_mpfr)):
        if t in tasks:
            ret.update(fn(model, batch, draws[t], seeds=seeds.get(t), **pre))
    if "itm" in tasks:
        ret.update(pretrain.compute_itm_wpa(model, batch, draws["itm"],
                                            seeds=seeds.get("itm"), **pre))
    common = dict(
        block_matrices=ts.block_matrices, train=train, text_view=cfg.text_view,
        image_view=cfg.image_view,
        attacked_text=_attacked_text_of(batch) if cfg.text_view else None,
        greedy_fn=greedy_fn, per_step_bs=global_batch(batch["text_ids"].shape[0]),
        attacked_image=batch.get("augmented_image") if cfg.augmentation else None,
        augmentation=cfg.augmentation)
    pgd = cfg.image_view and not cfg.augmentation
    if "moco" in tasks:
        pgd_fn = None
        if pgd:
            attack = make_pgd_moco(model, cfg.adv_steps_img, cfg.adv_lr_img,
                                   cfg.adv_max_norm_img, cfg.temperature)
            pgd_fn = lambda b, k, queue: attack(  # noqa: E731
                b, k, queue, block_matrices=ts.block_matrices)
        ret.update(contrastive.compute_moco_contrastive(
            model, batch, seeds=seeds.get("moco"),
            k_block_matrices=lambda: model.k_transformer.block_matrices(
                model.compute_dtype),
            pgd_fn=pgd_fn, temperature=cfg.temperature, momentum=cfg.momentum, **common))
    if "barlowtwins" in tasks:
        pgd_fn = None
        if pgd:
            attack = make_pgd_barlowtwins(model, cfg.adv_steps_img, cfg.adv_lr_img,
                                          cfg.adv_max_norm_img, cfg.adv_lr)
            pgd_fn = lambda b, k: attack(  # noqa: E731
                b, k, block_matrices=ts.block_matrices)
        ret.update(contrastive.compute_barlowtwins_contrastive(
            model, batch, seeds=seeds.get("barlowtwins"), pgd_fn=pgd_fn,
            adv_lr=cfg.adv_lr, **common))
    ds = dict(block_matrices=ts.block_matrices, train=train)
    attacked = dict(image_view=cfg.image_view, attacked_text=common["attacked_text"])
    if "vqa" in tasks:
        ret.update(downstream.compute_vqa(model, batch, seeds=seeds.get("vqa"), **ds))
    if "vqa_attacked" in tasks:
        ret.update(downstream.compute_vqa_attack(
            model, batch, seeds=seeds.get("vqa_attacked"), **ds, **attacked,
            pgd_fn=_build_pgd(cfg, ts, "vqa_attacked") if cfg.image_view else None))
    if "nlvr2" in tasks:
        ret.update(downstream.compute_nlvr2(model, batch, seeds=seeds.get("nlvr2"), **ds))
    if "nlvr2_attacked" in tasks:
        ret.update(downstream.compute_nlvr2_attack(
            model, batch, seeds=seeds.get("nlvr2_attacked"), **ds, **attacked,
            pgd_fn=_build_pgd(cfg, ts, "nlvr2_attacked") if cfg.image_view else None))
    if "irtr" in tasks:
        ret.update(downstream.compute_irtr(model, batch, seeds=seeds.get("irtr"),
                                           false_len=cfg.draw_false_text, **ds))
    if "irtr_attacked" in tasks:
        ret.update(downstream.compute_irtr_attacked(
            model, batch, seeds=seeds.get("irtr_attacked"), false_len=cfg.draw_false_text,
            **ds, **attacked,
            pgd_fn=_build_pgd(cfg, ts, "irtr_attacked") if cfg.image_view else None))
    total = sum(ret[k].float() for t in tasks for k in _TASK_LOSS_KEYS[t] if k in ret)
    return total, ret


def _scalar_metrics(ret: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in ret.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0}


def _global_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's scalar metrics of the global batch: each the mean over the
    data ranks of the rank's (a coupled loss is the same number on every rank,
    a per-sample mean the rank's part; ``lr`` is every rank's own)."""
    lr = metrics.pop("lr")
    return {**reduce_over_ranks(metrics, group=mesh.data_group()), "lr": lr}


# ------------------------------------------------------------- train step
def make_train_step(cfg, ts: TrainState, max_steps: Optional[int] = None) -> Callable:
    """``train_step(batch, generator) -> metrics`` over ``ts``, on the device
    its model lies on.  ``batch``: tensors on that device; ``generator``: a
    CPU ``torch.Generator`` the step draws its dropout seeds from.  Metrics
    are 0-d tensors on the device (no host read in the step), with
    ``total_loss`` and ``lr``, the base rate of this micro-batch's optimizer
    step (``ts.accum`` micro-batches per optimizer step).  Over several
    processes: this rank's b pairs of the global batch, the same generator
    on every rank, metrics of the global batch."""
    body = _train_step_body(cfg, ts, max_steps)

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return _global_metrics(body(batch, generator)[0])

    return train_step


def _train_step_body(cfg, ts: TrainState, max_steps: Optional[int]) -> Callable:
    """``body(batch, generator, greedy_fn=None) -> (metrics, ret)``: one
    step, shared by ``make_train_step`` and ``make_attacked_train_step``."""
    if cfg.fuse_moco_views:
        raise NotImplementedError("fuse_moco_views is not ported")
    lr_sched = make_lr_schedule(cfg, max_steps or resolve_max_steps(cfg))
    model = ts.model
    device = next(model.parameters()).device
    trainable = [p for p in model.parameters() if p.requires_grad]
    partial = [p for p in partial_params(model) if p.requires_grad]
    accum = ts.accum

    def body(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             greedy_fn: Optional[Callable] = None):
        seeds = task_seeds(cfg, generator, len(model.transformer.blocks),
                           batch["text_ids"].shape[0], device)
        draws = _draws_for(cfg, generator, batch, device)
        ts.optimizer.zero_grad(set_to_none=True)
        total, ret = compute_all_tasks(cfg, ts, batch, seeds, train=True,
                                       greedy_fn=greedy_fn, draws=draws)
        if total.requires_grad:      # no attacked view configured: nothing to learn from
            total.backward()
        for p in trainable:
            # a parameter the loss does not reach still decays, as its zero
            # gradient makes it do in the JAX package
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        micro = ts.step % accum
        if accum > 1:                # one multi-tensor launch per elementwise op
            grads = [p.grad for p in trainable]
            with torch.no_grad():
                delta = torch._foreach_sub(grads, ts.acc_grads)
                torch._foreach_div_(delta, micro + 1)
                torch._foreach_add_(ts.acc_grads, delta)
                if micro == accum - 1:
                    torch._foreach_copy_(grads, ts.acc_grads)
        if micro == accum - 1:
            all_reduce_grads(trainable, partial)   # the mean over ranks, once per cycle
            ts.optimizer.step()
            ts.scheduler.step()
            ts.refresh_block_matrices()
            if accum > 1:
                torch._foreach_zero_(ts.acc_grads)

        metrics = _scalar_metrics(ret)
        metrics["total_loss"] = total.detach()
        metrics["lr"] = torch.tensor(lr_sched(ts.step // accum), device=device)
        ts.step += 1
        return metrics, ret

    return body


# ------------------------------------------- the attacked train step
def make_attacked_train_step(cfg, ts: TrainState, greedy,
                             max_steps: Optional[int] = None) -> Callable:
    """``attacked_step(batch, generator) -> metrics``: the step of
    ``make_train_step`` with the greedy text attack inside it (port of the
    JAX package's ``make_attacked_train_step``, which compiles the attacker
    extras, the attack and the step as one program).  In a contrastive
    task's step the attack runs after the key forward, against the step's own
    keys: for moco after the momentum update and with the queue before the
    enqueue, so the twins move once per step; for barlowtwins with (k, B,
    adv_lr), k the key projection the step's head made in training mode (the
    JAX package's extras compute the same function of the same weights).  In
    a downstream task's it runs first, on the extras of
    ``attacks/greedy.py:greedy_attack_extras`` (the labels, the VQA targets, or
    IRTR's deterministic text projections).  Its ids become the text view's.

    ``greedy``: a ``FusedGreedyAttack``.  ``batch``: the step's batch plus
    the host tables under ``TABLE_KEYS`` (``greedy.prep_tables(text_ids)``,
    numpy arrays or tensors).  The metrics add ``num_changes`` and
    ``change_rate`` (0-d device tensors; no host read in the metrics)."""
    if not isinstance(greedy, FusedGreedyAttack):
        raise TypeError("make_attacked_train_step needs the fused greedy attacker")
    framework = greedy_attack_framework(cfg)
    if framework is None:
        raise ValueError("no attacked framework is active")
    body = _train_step_body(cfg, ts, max_steps)
    attack = greedy.build_attack_body()
    device = next(ts.model.parameters()).device

    def attacked_step(batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        tables = [torch.as_tensor(batch[k], device=device) for k in TABLE_KEYS[:-2]]
        tbucket = batch["gw_tbucket"]               # its shape carries the text bucket
        nw = torch.as_tensor(batch["gw_nw"], device=device)
        clean = {k: v for k, v in batch.items() if k not in TABLE_KEYS}

        def greedy_fn(b, extras):
            return attack(b, extras, *tables, tbucket, block_matrices=ts.block_matrices)

        if framework in CONTRASTIVE:
            metrics, ret = body(clean, generator, greedy_fn)
            nch = ret["n_changed"].float()
        else:
            clean = normalize_image_inputs(clean, ts.model.grid_hw, ts.model.patch_size)
            extras = greedy_attack_extras(cfg, ts.model, framework, clean, ts.block_matrices)
            ids, masks, nch = greedy_fn(clean, extras)
            metrics, _ = body(dict(clean, attacked_text_ids=ids, attacked_text_masks=masks),
                              generator)
            nch = nch.float()
        metrics["num_changes"] = nch.mean()
        metrics["change_rate"] = (nch / nw.float().clamp(min=1.0)).mean()
        return _global_metrics(metrics)

    return attacked_step


# -------------------------------------------------------------- eval step
def make_eval_step(cfg, ts: TrainState) -> Callable:
    """``eval_step(batch, generator=None) -> ret``: every active task's
    deterministic forward with its attacks (the reference validates on the
    adversarial views), the momentum twins, the queue and the BatchNorm
    running statistics untouched (BarlowTwins normalises with the latter), no
    gradient but the attacks' own; ``ret`` holds every output (per-sample
    ``_ps`` rows included) and ``total_loss``, on the device.  The
    pretraining tasks draw their ITM labels and MPP masks from ``generator``
    (``pretrain_draws``), which they need."""
    device = next(ts.model.parameters()).device

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        total, ret = compute_all_tasks(cfg, ts, batch, None, train=False,
                                       draws=_draws_for(cfg, generator, batch, device))
        ret["total_loss"] = torch.as_tensor(total, dtype=torch.float32)
        return ret

    return eval_step
