"""PGD image attacks (port of ``rmcl_tpu/attacks/pgd.py``: moco, barlowtwins,
nlvr2, vqa, irtr).

Behavioural spec: reference attack/pgd_attack_vilt.py.  The attack
differentiates a deterministic forward with respect to a pixel perturbation
delta through frozen parameters: every block forward is ``attn_half`` /
``mlp_half`` and every block backward their dx-only kernels
(``ops/fused_block.py``); nothing computes a weight gradient.

Update rule (reference :138-173), ``adv_steps`` times from delta = 0:
    g      = d loss / d delta                    (ascent: maximise loss)
    denorm = max(per-sample Linf norm of g, 1e-8)
    delta += adv_lr * g / denorm
    delta  = clip(delta, +-max_norm)             (if max_norm > 0)
The reference divides the loss by adv_steps before backward; the Linf
normalisation makes that factor a no-op, kept for parity.

The attack forward runs deterministically (no dropout), as in the JAX
package.

Hoisted-geometry fast path (default): the validity mask, the pos-embed
resample and the patch selection do not depend on delta (the gradient is
exactly zero on padding and unselected patches, see ``models/vit.py``
``VisualPrep``), so they are computed once from the clean image and each
iteration pays ``rows @ patch_kernel`` plus the transformer.  delta lives in
selected-patch space; its per-sample Linf norm equals the norm over the full
image because the complement is identically zero.  ``fast=False`` embeds
``image + delta`` afresh in every iteration.

Each ``make_pgd_*`` returns ``attack(batch, ...)`` that freezes the model's
parameters for its duration and returns delta in the batch's image layout
(patch rows, or the HWC canvas); NLVR2's returns one delta per image.  The
batch's images are normalised float patch rows or canvases.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from rmcl_tpu_torch.models.vit import as_patch_rows, from_patch_rows, scatter_delta
from rmcl_tpu_torch.objectives.contrastive import bt_correlation_loss, infonce
from rmcl_tpu_torch.objectives.losses import bce_with_logits, cross_entropy, l2_normalize
from rmcl_tpu_torch.parallel.dist import gather_rows


@contextlib.contextmanager
def _frozen(model: torch.nn.Module):
    """No parameter of ``model`` requires grad inside the block."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _fast_visual(model, batch, block_matrices, imgkey: str = "image",
                 image_token_type_idx: int = 1):
    """The per-iteration forward of the hoisted-geometry path for the image
    under ``imgkey``, embedded with token type ``image_token_type_idx``.

    Returns (fwd, delta_shape, to_full): fwd(delta_sel) runs the full infer
    with delta applied in selected-patch space, delta_shape is delta's
    (B, L, P*P*3) shape, and to_full(delta_sel) expands delta back to the
    batch's image layout: patch rows, or the canvas (B, H, W, 3) of
    ``image_layout="hwc"``, which enters as patch rows on its own grid."""
    img = batch[imgkey]
    if img.dim() not in (3, 4) or not img.is_floating_point():
        raise ValueError("the attack takes normalised float patch rows (B, N, P*P*3) "
                         "or a canvas (B, H, W, 3)")
    tr = model.transformer
    rows, grid = as_patch_rows(img, model.grid_hw, model.patch_size)
    with torch.no_grad():
        prep = tr.visual_embed_prepare(rows, grid, model.max_image_len)

    def fwd(delta_sel):
        emb, xm = tr.visual_embed_from_prep(prep, delta_sel, model.compute_dtype)
        return model.infer(batch, block_matrices, image_embeds=emb, image_masks=xm,
                           image_token_type_idx=image_token_type_idx)

    def to_full(delta_sel):
        d = scatter_delta(prep, delta_sel)
        return from_patch_rows(d, grid, model.patch_size) if img.dim() == 4 else d

    return fwd, prep.rows_sel.shape, to_full


def _linf_normalised_step(delta, grad, adv_lr: float, max_norm: float):
    g = grad.float()
    denorm = g.reshape(g.shape[0], -1).abs().amax(dim=1).clamp(min=1e-8)
    denorm = denorm.reshape(-1, *([1] * (g.dim() - 1)))
    delta = delta + (adv_lr * g / denorm).to(delta.dtype)
    if max_norm > 0:
        delta = delta.clamp(-max_norm, max_norm)
    return delta


def _pgd_loop(loss_of_deltas: Callable, shapes, dtype, device, adv_steps: int,
              adv_lr: float, max_norm: float, gate):
    """PGD over the deltas of ``shapes``, differentiated together, each
    updated only where ``gate`` says (NLVR2's ``attack_idx``)."""
    deltas = [torch.zeros(s, dtype=dtype, device=device) for s in shapes]
    for _ in range(adv_steps):
        for d in deltas:
            d.requires_grad_(True)
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_of_deltas(*deltas), deltas)
        deltas = [_linf_normalised_step(d.detach(), g, adv_lr, max_norm) if on else d.detach()
                  for d, g, on in zip(deltas, grads, gate)]
    return deltas


def _pgd_single_image(model, batch, head_loss: Callable,
                      adv_steps: int, adv_lr: float, max_norm: float, fast: bool,
                      block_matrices=None):
    """Shared fast/slow scaffold of the single-image PGD variants
    (moco, barlowtwins, vqa and irtr differ only in ``head_loss``).
    ``block_matrices``: the transformer's matrices already cast to the
    compute type (a training step keeps them), else cast here."""
    img = batch["image"]
    with _frozen(model):
        mats = block_matrices or model.transformer.block_matrices(model.compute_dtype)
        if fast:
            fwd, dshape, to_full = _fast_visual(model, batch, mats)
            delta, = _pgd_loop(lambda d: head_loss(fwd(d)), (dshape,), img.dtype,
                               img.device, adv_steps, adv_lr, max_norm, gate=(True,))
            return to_full(delta)

        def loss_of(delta):
            return head_loss(model.infer(dict(batch, image=img + delta), mats))

        return _pgd_loop(loss_of, (img.shape,), img.dtype, img.device,
                         adv_steps, adv_lr, max_norm, gate=(True,))[0]


# ------------------------------------------------------------------ MoCo
def make_pgd_moco(model, adv_steps: int, adv_lr: float, max_norm: float,
                  temperature: float, fast: bool = True):
    """InfoNCE-ascent PGD (reference PGDAttack_moco.pgd_attack :130-175).
    ``k_modality`` (B, 128): normalised keys; ``neg_queue`` (128, K)."""

    def attack(batch: Dict[str, torch.Tensor], k_modality, neg_queue,
               block_matrices=None):
        k_modality, neg_queue = k_modality.detach(), neg_queue.detach()

        def head_loss(infer):
            q = l2_normalize(model.moco_head(infer["cls_feats"]), dim=1)
            loss, _ = infonce(q, k_modality, neg_queue, temperature)
            return loss / adv_steps

        return _pgd_single_image(model, batch, head_loss,
                                 adv_steps, adv_lr, max_norm, fast, block_matrices)

    return attack


# ----------------------------------------------------------- BarlowTwins
def make_pgd_barlowtwins(model, adv_steps: int, adv_lr: float, max_norm: float,
                         bt_lambda: float, fast: bool = True):
    """Cross-correlation-ascent PGD (reference PGDAttack_bartlowtwins
    .pgd_attack :198-238).  The head's BatchNorms run in training mode and
    their running statistics stay as they are; the correlation divides by
    the attacked batch's own size (the reference's local batch, :219), which
    over several processes is the global batch, as the JAX package's pjit
    step sees it: every iteration the head reads every rank's class features
    of that iteration (``parallel/dist.py:gather_rows``).  ``k_modality``
    (global B, D): the detached key projections."""

    def attack(batch: Dict[str, torch.Tensor], k_modality, block_matrices=None):
        k_modality = k_modality.detach()

        def head_loss(infer):
            q = model.barlowtwins_head(gather_rows(infer["cls_feats"]), training=True)
            loss, _, _ = bt_correlation_loss(q, k_modality, q.shape[0], bt_lambda)
            return loss / adv_steps

        return _pgd_single_image(model, batch, head_loss,
                                 adv_steps, adv_lr, max_norm, fast, block_matrices)

    return attack


# ---------------------------------------------------------------- NLVR2
def make_pgd_nlvr2(model, adv_steps: int, adv_lr: float, max_norm: float,
                   attack_idx=(True, True), fast: bool = True):
    """Two-image CE-ascent PGD with per-image gating by ``attack_idx``
    (reference PGDAttack_nlvr2.pgd_attack :263-342): both images' deltas come
    from one gradient of the NLVR2 loss, and image i moves only where
    ``attack_idx[i]``.  ``labels`` (B,).  Returns (delta_0, delta_1)."""
    gate = tuple(bool(a) for a in attack_idx)

    def attack(batch: Dict[str, torch.Tensor], labels, block_matrices=None):
        labels = labels.detach()
        img0, img1 = batch["image_0"], batch["image_1"]

        def head_loss(i1, i2):
            cls = torch.cat([i1["cls_feats"], i2["cls_feats"]], dim=-1)
            return cross_entropy(model.nlvr2_classifier(cls), labels) / adv_steps

        with _frozen(model):
            mats = block_matrices or model.transformer.block_matrices(model.compute_dtype)
            if fast:
                fwd0, shape0, full0 = _fast_visual(model, batch, mats, "image_0", 1)
                fwd1, shape1, full1 = _fast_visual(model, batch, mats, "image_1", 2)
                d0, d1 = _pgd_loop(lambda a, b: head_loss(fwd0(a), fwd1(b)),
                                   (shape0, shape1), img0.dtype, img0.device,
                                   adv_steps, adv_lr, max_norm, gate)
                return full0(d0), full1(d1)

            def loss_of(a, b):
                bb = dict(batch, image_0=img0 + a, image_1=img1 + b)
                return head_loss(model.infer(bb, mats, image_token_type_idx=1),
                                 model.infer(bb, mats, image_token_type_idx=2))

            d0, d1 = _pgd_loop(loss_of, (img0.shape, img1.shape), img0.dtype, img0.device,
                               adv_steps, adv_lr, max_norm, gate)
            return d0, d1

    return attack


# ------------------------------------------------------------------ VQA
def make_pgd_vqa(model, adv_steps: int, adv_lr: float, max_norm: float,
                 label_size: int, fast: bool = True):
    """BCE-ascent PGD (reference PGDAttack_vqa.pgd_attack :439-483).
    ``vqa_targets`` is the dense (B, label_size) soft-score matrix."""

    def attack(batch: Dict[str, torch.Tensor], vqa_targets, block_matrices=None):
        vqa_targets = vqa_targets.detach()

        def head_loss(infer):
            logits = model.vqa_classifier(infer["cls_feats"])
            return bce_with_logits(logits, vqa_targets) * label_size

        return _pgd_single_image(model, batch, head_loss,
                                 adv_steps, adv_lr, max_norm, fast, block_matrices)

    return attack


# ------------------------------------------------------------------ IRTR
def make_pgd_irtr(model, adv_steps: int, adv_lr: float, max_norm: float,
                  temperature: float, fast: bool = True):
    """IRTR PGD, with the JAX package's repaired semantics (the reference
    variant, PGDAttack_irtr :364-415, cannot run): push the moco-projected
    joint cls AWAY from its own text projection and TOWARD the other
    in-batch text projections.  The denominator uses negatives only: with
    the positive included, a batch of one collapses to a constant-zero
    softmax whose gradient is identically zero.  ``text_repr``: (N, 128)
    normalised, the panel of texts: the attacked batch's own (N = B; the
    recall's per-image loop) or, in a training step over several processes,
    every rank's (N the global batch: ``objectives/downstream.py:
    irtr_text_panel``); ``row0``: the row of the attacked batch's first pair
    in it.  The means are over the panel's N rows, as the JAX package's are
    over its global batch."""

    def attack(batch: Dict[str, torch.Tensor], text_repr, row0: int = 0,
               block_matrices=None):
        text_repr = text_repr.detach()
        N = text_repr.shape[0]

        def head_loss(infer):
            q = l2_normalize(model.moco_head(infer["cls_feats"]), dim=1)
            logits = (q.float() @ text_repr.float().t()) / temperature
            cols = torch.arange(row0, row0 + logits.shape[0], device=logits.device)[:, None]
            loss = -logits.gather(1, cols).sum() / N
            if N > 1:
                own = torch.arange(N, device=logits.device)[None, :] == cols
                loss = loss + torch.logsumexp(logits.masked_fill(own, float("-inf")),
                                              dim=1).sum() / N
            return loss / adv_steps

        return _pgd_single_image(model, batch, head_loss,
                                 adv_steps, adv_lr, max_norm, fast, block_matrices)

    return attack
