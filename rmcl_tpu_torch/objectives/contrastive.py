"""The two contrastive objectives (port of ``rmcl_tpu/objectives/contrastive.py``):
MoCo (``momentum_update``, ``dequeue_and_enqueue``, ``infonce`` and the
unfused ``compute_moco_contrastive``; ``fuse_moco_views`` is not ported) and
BarlowTwins (``bt_correlation_loss`` and ``compute_barlowtwins_contrastive``).

Behavioural spec: reference vilt/modules/objectives.py
compute_moco_contrastive:217-447 and compute_barlowtwins:449-602.  Where the
JAX package returns new parameter and state pytrees, the port updates the
model's momentum twins, its queue buffers and the BarlowTwins head's
BatchNorm running statistics in place, under ``no_grad``: they are never
differentiated.

Over several processes (``parallel/dist.py``) each objective computes what
the JAX package's pjit step computes on the global batch: MoCo enqueues the
keys of every rank, in rank order, so that every rank's queue and pointer
stay identical, and its loss is per sample; BarlowTwins' head (its BatchNorm
statistics) and correlation loss run on every rank's rows, and every rank
computes the same global loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from rmcl_tpu_torch.objectives.losses import cosine_similarity, cross_entropy, l2_normalize
from rmcl_tpu_torch.parallel.dist import gather_rows

MOMENTUM_TWINS = ("text_embeddings", "token_type_embeddings", "transformer", "moco_head")


# ----------------------------------------------------------- EMA update
@torch.no_grad()
def momentum_update(model: torch.nn.Module, m: float, twins=MOMENTUM_TWINS) -> None:
    """k = m*k + (1-m)*q for the twin module groups, in place
    (reference objectives.py:256-260)."""
    ks: List[torch.Tensor] = []
    qs: List[torch.Tensor] = []
    for name in twins:
        if hasattr(model, "k_" + name):
            ks += list(getattr(model, "k_" + name).parameters())
            qs += list(getattr(model, name).parameters())
    if ks:
        torch._foreach_mul_(ks, m)
        torch._foreach_add_(ks, qs, alpha=1.0 - m)


# ---------------------------------------------------------- queue update
@torch.no_grad()
def dequeue_and_enqueue(model: torch.nn.Module, keys: torch.Tensor,
                        per_step_bs: int) -> None:
    """Circular write of the key batch (B, 128) into the negatives queue
    (128, K) at the pointer, in place (reference objectives.py:238-248).
    A partial batch is skipped, as the reference does; K must be a multiple
    of the batch, or the write would run past the end while the pointer
    wraps."""
    B = keys.shape[0]
    if B != per_step_bs:
        return
    queue, ptr = model.proj_queue, model.proj_queue_ptr
    K = queue.shape[1]
    if K % B != 0:
        raise ValueError(f"num_negative ({K}) must be divisible by the global batch "
                         f"({B}) — reference queue invariant")
    cols = (ptr.long() + torch.arange(B, device=ptr.device)) % K   # no host read
    queue.index_copy_(1, cols, keys.t().to(queue.dtype))
    ptr.copy_((ptr + B) % K)


# -------------------------------------------------------------- InfoNCE
def infonce(q: torch.Tensor, k: torch.Tensor, neg_queue: torch.Tensor,
            temperature: float):
    """logits = [q.k | q.queue] / tau in fp32, labels = 0 (reference
    objectives.py:271-274).  q, k: (N, 128); neg_queue: (128, K).
    Returns (loss, logits)."""
    q32 = q.float()
    l_pos = (q32 * k.float()).sum(-1, keepdim=True)
    l_neg = q32 @ neg_queue.float()
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    return cross_entropy(logits, labels), logits


def _infonce_rows(logits: torch.Tensor) -> torch.Tensor:
    """Per-sample InfoNCE NLL (label 0): its mean is the infonce loss."""
    return -torch.log_softmax(logits.float(), dim=-1)[:, 0]


def _view_diagnostics(q, k, neg_queue, suffix: str) -> Dict[str, torch.Tensor]:
    """Positive and negative L2 / cosine / dot panels (reference
    objectives.py:300-312), batched; the three negative panels come from one
    (B, K) product and the queue's column norms."""
    q32, k32, n32 = q.float(), k.float(), neg_queue.float()
    cos = (q32 * k32).sum(1) / (torch.linalg.vector_norm(q32, dim=1).clamp(min=1e-6)
                                * torch.linalg.vector_norm(k32, dim=1).clamp(min=1e-6))
    ret = {
        f"pos_dist_attacked_{suffix}": torch.linalg.vector_norm(q32 - k32, dim=1).mean(),
        f"pos_cosine_attacked_{suffix}": cos.mean(),
        f"pos_dot_attacked_{suffix}": (q32 * k32).sum(1).mean(),
    }
    s = q32 @ n32                                         # (B, K) dots
    qn2 = (q32 ** 2).sum(1)
    nn2 = (n32 ** 2).sum(0)
    d2 = qn2[:, None] - 2 * s + nn2[None, :]
    ret[f"neg_dist_attacked_{suffix}"] = d2.clamp(min=0).sqrt().mean()
    denom = qn2.sqrt().clamp(min=1e-6)[:, None] * nn2.sqrt().clamp(min=1e-6)[None, :]
    ret[f"neg_cosine_attacked_{suffix}"] = (s / denom).mean()
    ret[f"neg_dot_attacked_{suffix}"] = s.mean()
    return ret


# ------------------------------------------------------------- MoCo main
def compute_moco_contrastive(
    model, batch: Dict[str, torch.Tensor], *,
    seeds: Optional[torch.Tensor] = None,
    block_matrices=None,
    k_block_matrices: Optional[Callable] = None,
    train: bool = True,
    text_view: bool = False,
    image_view: bool = False,
    attacked_text: Optional[Dict[str, torch.Tensor]] = None,
    pgd_fn: Optional[Callable] = None,
    greedy_fn: Optional[Callable] = None,
    temperature: float = 0.07,
    momentum: float = 0.999,
    per_step_bs: int = 0,
    attacked_image: Optional[torch.Tensor] = None,
    augmentation: bool = False,
) -> Dict[str, torch.Tensor]:
    """One MoCo step (reference objectives.py:217-447): momentum update, key
    forward, the optional PGD image attack, the clean and attacked query
    views, the enqueue.  The caller differentiates ``ret["moco_loss"]``.

    ``seeds``: (4, layers + 1, 2, B) int32 (``models/vilt.py:draw_seeds``),
    one set per view in the order clean, txt, img, both; needed when
    ``train``.  ``block_matrices``: the query transformer's matrices cast to
    the compute type; ``k_block_matrices()``: the same for the momentum
    twins, called after the momentum update.  ``attacked_text``:
    {"text_ids", "text_masks"} from the text attack or augmentation; None
    disables the text view.  ``pgd_fn(batch, k, queue) -> img_delta``
    (``attacks/pgd.py``).  ``greedy_fn(batch, k, queue) -> (ids, masks,
    n_changed)``, the greedy text attack (``attacks/greedy_fused.py``), runs
    after the key forward on the step's own post-update keys and the queue
    before the enqueue (the JAX package's attacker extras, handed over as
    ``greedy_fn(batch, (k, queue, temperature))``): its ids take the place of
    ``attacked_text`` and ``ret["n_changed"]`` holds its (B,) per-sample
    change counts.  ``augmentation=True`` (benign views, the image
    view given as ``attacked_image``) disables the combined view, as the
    reference does (objectives.py:356).  The momentum twins and the queue
    are updated in place when ``train``.  ``per_step_bs``: the global batch;
    the enqueue writes every rank's keys (``gather_rows``), a batch of
    another size is skipped.
    """
    ret: Dict[str, torch.Tensor] = {}
    if train:
        momentum_update(model, momentum)

    # ---- key (momentum) forward, no grad ----
    with torch.no_grad():
        infer_k = model.infer_k(
            batch, block_matrices=k_block_matrices() if k_block_matrices else None)
        k = l2_normalize(model.k_moco_head(infer_k["cls_feats"]), dim=1)
    neg_queue = model.proj_queue.detach().clone() if train else model.proj_queue.detach()

    if greedy_fn is not None:
        ids, masks, ret["n_changed"] = greedy_fn(batch, (k, neg_queue, temperature))
        attacked_text = {"text_ids": ids, "text_masks": masks}

    attacked_img_batch = None
    if image_view and attacked_image is not None:
        attacked_img_batch = dict(batch, image=attacked_image)
    elif image_view and pgd_fn is not None:
        img_delta = pgd_fn(batch, k, neg_queue).detach()
        attacked_img_batch = dict(batch, image=batch["image"] + img_delta)
        ret["pgd_delta"] = torch.linalg.vector_norm(img_delta.float(), dim=-1).mean()

    def query(view_batch, view: int):
        infer = model.infer(view_batch, block_matrices, deterministic=not train,
                            seeds=seeds[view] if train else None)
        q = l2_normalize(model.moco_head(infer["cls_feats"]), dim=1)
        return (q, *infonce(q, k, neg_queue, temperature))

    # ---- clean query: only its predictions are used, so no graph ----
    with torch.no_grad():
        pred_orig = query(batch, 0)[2].argmax(-1)

    loss, loss_num = 0.0, 0
    views = []
    if text_view and attacked_text is not None:
        views.append(("txt", "geom", 1, dict(batch, **attacked_text)))
    if image_view and attacked_img_batch is not None:
        views.append(("img", "pgd", 2, attacked_img_batch))
    if (text_view and image_view and not augmentation
            and attacked_text is not None and attacked_img_batch is not None):
        views.append(("both", "both", 3, dict(attacked_img_batch, **attacked_text)))
    for name, rate, view, view_batch in views:
        q, l_view, logits = query(view_batch, view)
        ret[f"{rate}_success_rate"] = (logits.argmax(-1) != pred_orig).float().mean()
        with torch.no_grad():
            ret.update(_view_diagnostics(q, k, neg_queue, name))
            ret[f"attacked_{name}_loss_ps"] = _infonce_rows(logits)
        ret[f"attacked_{name}_loss"] = l_view
        loss = loss + l_view
        loss_num += 1

    if train:
        keys = gather_rows(k)
        dequeue_and_enqueue(model, keys, per_step_bs or keys.shape[0])

    ret["moco_loss"] = torch.as_tensor(loss / max(loss_num, 1), dtype=torch.float32,
                                       device=k.device)
    if views:
        ret["moco_loss_ps"] = sum(ret[f"attacked_{n}_loss_ps"]
                                  for n, *_ in views) / max(loss_num, 1)
    return ret


# ---------------------------------------------------------- Barlow-Twins
def _off_diagonal_sumsq(c: torch.Tensor) -> torch.Tensor:
    mask = 1.0 - torch.eye(c.shape[0], dtype=c.dtype, device=c.device)
    return ((c * mask) ** 2).sum()


def bt_correlation_loss(q: torch.Tensor, k: torch.Tensor, per_step_bs: int, lam: float):
    """sum_d (1 - c_dd)^2 + lam * sum_{d != e} c_de^2 with c = q^T k /
    per_step_bs, in fp32 (reference objectives.py:476-482).  Returns (loss,
    on-diagonal, lam * off-diagonal).

    With B < D, c (D x D) has rank <= B and is never formed: its diagonal is
    sum_n q_nd k_nd / psb and ||c||_F^2 = sum_ij (q q^T)_ij (k k^T)_ij / psb^2,
    two (B, B) Gram matrices, so the off-diagonal sum is ||c||^2 - sum_d
    c_dd^2.  With B >= D the (D, D) matrix is the cheap side and is formed.
    Both give the same value up to summation order, as in the JAX package."""
    q32, k32 = q.float(), k.float()
    B, D = q32.shape
    if B >= D:
        c = (q32.t() @ k32) / per_step_bs
        on_diag = ((torch.diagonal(c) - 1.0) ** 2).sum()
        off_diag = _off_diagonal_sumsq(c)
        return on_diag + lam * off_diag, on_diag, lam * off_diag
    diag = (q32 * k32).sum(0) / per_step_bs                      # (D,)
    gq = q32 @ q32.t()                                           # (B, B)
    gk = k32 @ k32.t()
    sum_sq = (gq * gk).sum() / (per_step_bs * per_step_bs)
    on_diag = ((diag - 1.0) ** 2).sum()
    off_diag = sum_sq - (diag ** 2).sum()
    return on_diag + lam * off_diag, on_diag, lam * off_diag


def _bt_diagnostics(q, k, suffix: str) -> Dict[str, torch.Tensor]:
    """L2 distance, cosine and dot of each view projection with its key,
    batch means, in fp32 (reference objectives.py:487-491)."""
    q32, k32 = q.float(), k.float()
    return {f"pos_dist_attacked_{suffix}": torch.linalg.vector_norm(q32 - k32, dim=1).mean(),
            f"pos_cosine_attacked_{suffix}": cosine_similarity(q32, k32).mean(),
            f"pos_dot_attacked_{suffix}": (q32 * k32).sum(1).mean()}


def compute_barlowtwins_contrastive(
    model, batch: Dict[str, torch.Tensor], *,
    seeds: Optional[torch.Tensor] = None,
    block_matrices=None,
    train: bool = True,
    text_view: bool = False,
    image_view: bool = False,
    attacked_text: Optional[Dict[str, torch.Tensor]] = None,
    pgd_fn: Optional[Callable] = None,
    greedy_fn: Optional[Callable] = None,
    adv_lr: float = 0.0051,
    per_step_bs: int = 0,
    attacked_image: Optional[torch.Tensor] = None,
    augmentation: bool = False,
) -> Dict[str, torch.Tensor]:
    """One BarlowTwins step (reference objectives.py:449-602): the key
    forward, the optional greedy and PGD attacks, the text, image and
    combined views, each scored by ``bt_correlation_loss`` against the key
    with lambda ``adv_lr``.  The caller differentiates
    ``ret["barlowtwins_loss"]``, the mean of the view losses.

    The key is the deterministic query forward and the head, detached.  The
    head's BatchNorms run in training mode when ``train``, and their running
    statistics then move in place at every head call, chained in the order
    key, text, image, both (the JAX package merges each call's new
    statistics before the next); ``train=False`` normalises with the running
    statistics and moves nothing.  ``seeds``, ``block_matrices``,
    ``attacked_text``, ``attacked_image`` and ``augmentation`` as in
    ``compute_moco_contrastive``: ``seeds[1]``, ``[2]``, ``[3]`` drop out the
    text, image and combined views.  ``pgd_fn(batch, k) -> img_delta``;
    ``greedy_fn(batch, (k, per_step_bs, adv_lr)) -> (ids, masks,
    n_changed)``, run after the key forward (its ids take the place of
    ``attacked_text``; ``ret["n_changed"]`` holds the change counts).  There
    is no clean query view, no momentum encoder and no queue.

    Every head call takes the class features of every rank (``gather_rows``),
    so the key ``k`` and each view's projection are the global batch's, the
    BatchNorm statistics and the correlation (over ``per_step_bs``, by
    default the rows of ``k``) too; the attacks get the global key."""
    ret: Dict[str, torch.Tensor] = {}
    head = model.barlowtwins_head

    with torch.no_grad():
        k = head(gather_rows(model.infer(batch, block_matrices)["cls_feats"]),
                 training=train, update=train)
    psb = per_step_bs or k.shape[0]

    if greedy_fn is not None:
        ids, masks, ret["n_changed"] = greedy_fn(batch, (k, psb, adv_lr))
        attacked_text = {"text_ids": ids, "text_masks": masks}

    attacked_img_batch = None
    if image_view and attacked_image is not None:
        attacked_img_batch = dict(batch, image=attacked_image)
    elif image_view and pgd_fn is not None:
        attacked_img_batch = dict(batch, image=batch["image"] + pgd_fn(batch, k).detach())

    views = []
    if text_view and attacked_text is not None:
        views.append(("text", "txt", 1, dict(batch, **attacked_text)))
    if image_view and attacked_img_batch is not None:
        views.append(("img", "img", 2, attacked_img_batch))
    if (text_view and image_view and not augmentation
            and attacked_text is not None and attacked_img_batch is not None):
        views.append(("both", "both", 3, dict(attacked_img_batch, **attacked_text)))
    loss = 0.0
    for name, suffix, view, view_batch in views:
        infer = model.infer(view_batch, block_matrices, deterministic=not train,
                            seeds=seeds[view] if train else None)
        q = head(gather_rows(infer["cls_feats"]), training=train, update=train)
        l_view, on, off = bt_correlation_loss(q, k, psb, adv_lr)
        ret[f"barlowtwins_loss_invariance_{name}"] = on
        ret[f"barlowtwins_loss_redundancy_{name}"] = off
        with torch.no_grad():
            ret.update(_bt_diagnostics(q, k, suffix))
        loss = loss + l_view
    ret["barlowtwins_loss"] = torch.as_tensor(loss / max(len(views), 1), dtype=torch.float32,
                                              device=k.device)
    return ret
