"""The pretraining objectives: MLM, MPP, ITM with word-patch alignment, and
the masked-patch regressions MPPD / MPFR (port of
``rmcl_tpu/objectives/pretrain.py``).

Behavioural spec: reference vilt/modules/objectives.py compute_mlm:604-630,
compute_mpp:632-665, compute_itm_wpa:714-787; MPPD and MPFR (:668-711) are
dormant there and completed as the JAX package completes them, on the
patch-row layout: pixel-vector and patch-feature MSE on the masked patches.

The random draws are arguments, made by the step (``train/step.py:
pretrain_draws``): ``masks`` (2, B, N) bool, MPP's masked and replaced patches
over every patch, and ``itm_labels`` (B,), a permutation of B // 2 ones and
B - B // 2 zeros.  ``seeds`` are the forward's dropout seeds
(``models/vilt.py:draw_seeds``, one set).  Output keys are the JAX
package's, letter for letter: every ``*_loss`` with the ``_ps`` / ``_wt``
rows ``eval/metrics.py`` recombines, the logits and labels its accuracies
read.  Logits stay in the compute type; every loss is fp32, and so is the
optimal-transport alignment (``objectives/ot.py``), whose plan carries no
gradient.

Over several processes the token and masked-patch means of MLM, MPP, MPPD
and MPFR divide by the global batch's count (``parallel/dist.py:
batch_mean``), as the JAX package's global batch does; the per-sample means
(ITM, and the word-patch alignment's ``/ n``) need nothing over equal
per-rank batches.
"""

from __future__ import annotations

from typing import Dict

import torch

from rmcl_tpu_torch.models.vit import as_patch_rows
from rmcl_tpu_torch.objectives.downstream import _infer
from rmcl_tpu_torch.objectives.losses import cross_entropy, cross_entropy_per_sample
from rmcl_tpu_torch.objectives.ot import cost_matrix_cosine, ipot, trace_bmm
from rmcl_tpu_torch.parallel.dist import batch_mean

OT_BETA, OT_ITERATIONS = 0.5, 50
WPA_WEIGHT = 0.1


# ------------------------------------------------------------------- MLM
def compute_mlm(model, batch, *, seeds=None, block_matrices=None,
                train: bool = False) -> Dict[str, torch.Tensor]:
    """The MLM collator's masked text (``text_ids_mlm`` / ``text_labels_mlm``)
    against the clean image; cross entropy over every labelled token."""
    infer = _infer(model, batch, block_matrices, train, seeds, mask_text=True)
    logits = model.mlm_score(infer["text_feats"])
    labels = infer["text_labels"].long()
    ps, wt = cross_entropy_per_sample(logits, labels)
    valid = labels != -100
    correct = (logits.argmax(-1) == labels) & valid
    return {"mlm_loss": batch_mean(ps.sum(), wt.sum()),
            "mlm_loss_ps": ps, "mlm_loss_wt": wt, "mlm_logits": logits,
            "mlm_labels": labels, "mlm_ids": infer["text_ids"],
            "mlm_step_accuracy": batch_mean(correct.sum(), valid.sum())}


# ------------------------------------------------------------------- MPP
def compute_mpp(model, batch, masks: torch.Tensor, *, seeds=None, block_matrices=None,
                train: bool = False) -> Dict[str, torch.Tensor]:
    """256-way cross entropy per colour channel of each masked patch."""
    infer = _infer(model, batch, block_matrices, train, seeds, mask_image=masks)
    logits = model.mpp_score(infer["image_feats"])
    B, S, _ = logits.shape
    logits = logits.reshape(B, S, 3, 256)
    labels = infer["image_labels"]                            # (B, S, 3)
    ps, wt = cross_entropy_per_sample(logits, labels)
    return {"mpp_loss": batch_mean(ps.sum(), wt.sum()),
            "mpp_loss_ps": ps, "mpp_loss_wt": wt, "mpp_logits": logits,
            "mpp_labels": labels}


# ------------------------------------------------- ITM + word-patch alignment
def compute_itm_wpa(model, batch, itm_labels: torch.Tensor, *, seeds=None,
                    block_matrices=None, train: bool = False) -> Dict[str, torch.Tensor]:
    """ITM on the true image where ``itm_labels`` is 1 and ``false_image_0``
    where it is 0, plus 0.1 x the IPOT alignment distance between the text
    tokens (without [CLS] and the final [SEP]) and the image patches (without
    the class token), positives minus negatives over B."""
    sel = itm_labels.reshape((-1,) + (1,) * (batch["image"].dim() - 1)) == 1
    mixed = dict(batch, image=torch.where(sel, batch["image"], batch["false_image_0"]))
    infer = _infer(model, mixed, block_matrices, train, seeds)

    txt_mask = infer["text_masks"].bool()
    img_mask = infer["image_masks"].bool()
    lens = txt_mask.sum(1)
    pos = torch.arange(txt_mask.shape[1], device=txt_mask.device)[None, :]
    txt_mask = txt_mask & (pos != (lens - 1)[:, None]) & (pos != 0)
    img_mask = torch.cat([torch.zeros_like(img_mask[:, :1]), img_mask[:, 1:]], dim=1)
    txt_pad, img_pad = ~txt_mask, ~img_mask

    cost = cost_matrix_cosine(infer["text_feats"], infer["image_feats"])
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, 0.0, cost)
    txt_len = (txt_pad.shape[1] - txt_pad.sum(1)).float()
    img_len = (img_pad.shape[1] - img_pad.sum(1)).float()
    T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad, joint_pad, OT_BETA,
             OT_ITERATIONS, 1)
    distance = trace_bmm(cost, T)

    positive = itm_labels == 1
    signed = torch.where(positive, distance, -distance)
    logits = model.itm_score(infer["cls_feats"])
    labels = itm_labels.long()
    return {"itm_loss": cross_entropy(logits, labels),
            "itm_loss_ps": cross_entropy_per_sample(logits, labels)[0],
            "itm_wpa_loss": WPA_WEIGHT * signed.sum() / distance.shape[0],
            # the signed per-sample distance: itm_wpa_loss == mean(ps)
            "itm_wpa_loss_ps": WPA_WEIGHT * signed,
            "itm_logits": logits, "itm_labels": labels,
            "itm_step_accuracy": (logits.argmax(-1) == labels).float().mean()}


# ---------------------------------------------------- MPPD / MPFR (dormant)
def _gather_patches(a: torch.Tensor, pidx: torch.Tensor, gw: int) -> torch.Tensor:
    """The rows of ``a`` (B, N, F) at the selected patches' grid coordinates
    ``pidx`` (B, L, 2)."""
    flat = pidx[..., 0] * gw + pidx[..., 1]
    return torch.gather(a, 1, flat[..., None].expand(-1, -1, a.shape[-1]))


def _masked_mse(name: str, logits, targets, image_labels) -> Dict[str, torch.Tensor]:
    masked = (image_labels[:, 1:] != -100).any(-1)            # (B, L)
    diff = torch.where(masked[..., None], (logits.float() - targets.float()) ** 2, 0.0)
    F = diff.shape[-1]
    return {f"{name}_loss": batch_mean(diff.sum(), masked.sum() * F),
            f"{name}_logits": logits, f"{name}_loss_ps": diff.sum((1, 2)),
            f"{name}_loss_wt": (masked.sum(1) * F).float(), f"{name}_labels": targets}


def compute_mppd(model, batch, masks: torch.Tensor, *, seeds=None, block_matrices=None,
                 train: bool = False) -> Dict[str, torch.Tensor]:
    """Masked-patch dense regression: each masked patch's normalised pixel
    row (P*P*3) from its output feature."""
    infer = _infer(model, batch, block_matrices, train, seeds, mask_image=masks)
    rows, grid = as_patch_rows(batch["image"], model.grid_hw, model.patch_size)
    targets = _gather_patches(rows, infer["patch_index"], grid[1])
    logits = model.mppd_score(infer["image_feats"][:, 1:])
    return _masked_mse("mppd", logits, targets, infer["image_labels"])


def compute_mpfr(model, batch, masks: torch.Tensor, *, seeds=None, block_matrices=None,
                 train: bool = False) -> Dict[str, torch.Tensor]:
    """Masked-patch feature regression: each masked patch's clean patch
    embedding (fp32, no gradient) from its output feature."""
    infer = _infer(model, batch, block_matrices, train, seeds, mask_image=masks)
    with torch.no_grad():
        rows, grid = as_patch_rows(batch["image"], model.grid_hw, model.patch_size)
        clean = model.transformer.patch_embed(rows.float(), torch.float32)
        targets = _gather_patches(clean, infer["patch_index"], grid[1])
    logits = model.mpfr_score(infer["image_feats"][:, 1:])
    return _masked_mse("mpfr", logits, targets, infer["image_labels"])
