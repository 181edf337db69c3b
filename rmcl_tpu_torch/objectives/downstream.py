"""The downstream objectives, clean and attacked: VQA, NLVR2 and IRTR (port of
``rmcl_tpu/objectives/downstream.py``).

Behavioural spec: reference vilt/modules/objectives.py compute_vqa:861-896,
compute_vqa_attack:813-858, compute_nlvr2:1002-1060,
compute_nlvr2_attack:898-1000, compute_irtr:1180-1222,
compute_irtr_attacked:1062-1178.  As in the JAX package:

  * the VQA soft targets arrive as a dense (B, label_size) matrix from the
    collator;
  * IRTR takes the true text and the ``draw_false_text`` false ones as
    ``false_text_{i}_ids`` / ``_masks`` and stacks them (B, F+1, T); each
    image is embedded once, without dropout, and broadcast over its F+1
    texts before the transformer (its gradient sums over the broadcast);
  * the attacked NLVR2 loss is ``nlvr2_attacked_loss``, scored against the
    true labels, and ``nlvr2_flip_rate`` is the share of predictions the
    attack flipped.

Output keys are the JAX package's, letter for letter (``eval/metrics.py``
and the Trainer read them).  ``seeds`` are the training forwards' dropout
seeds (``models/vilt.py:draw_seeds``): VQA one set, NLVR2 two (one per
image), IRTR one over the B * (F+1) rows.  The attacked variants reuse the
clean pass's seeds for the attacked pass, as the JAX package passes the one
``rng`` to both.  ``block_matrices``: the transformer's matrices in the
compute type (``ViT.block_matrices``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from rmcl_tpu_torch.objectives.losses import (bce_rowsum_with_logits, bce_with_logits,
                                              cross_entropy, cross_entropy_per_sample,
                                              l2_normalize)
from rmcl_tpu_torch.parallel.mesh import data_rank
from rmcl_tpu_torch.parallel.dist import gather_rows


def _infer(model, batch, block_matrices, train: bool, seeds, **kw):
    return model.infer(batch, block_matrices, deterministic=not train,
                       seeds=seeds if train else None, **kw)


def _with_text(batch, attacked_text):
    return batch if attacked_text is None else dict(batch, **attacked_text)


# ------------------------------------------------------------------- VQA
def _vqa_outputs(model, batch, block_matrices, train, seeds):
    infer = _infer(model, batch, block_matrices, train, None if seeds is None else seeds[0])
    logits = model.vqa_classifier(infer["cls_feats"])
    targets = batch["vqa_targets"]
    return logits, targets, bce_with_logits(logits, targets) * targets.shape[1]


def compute_vqa(model, batch, *, seeds=None, block_matrices=None,
                train: bool = False) -> Dict[str, torch.Tensor]:
    logits, targets, loss = _vqa_outputs(model, batch, block_matrices, train, seeds)
    score = targets.gather(1, logits.argmax(-1)[:, None])[:, 0].float().mean()
    return {"vqa_loss": loss, "vqa_logits": logits, "vqa_targets": targets,
            "vqa_loss_ps": bce_rowsum_with_logits(logits, targets),
            "vqa_step_score": score}


def compute_vqa_attack(model, batch, *, seeds=None, block_matrices=None,
                       train: bool = False, image_view: bool = False,
                       attacked_text: Optional[Dict[str, torch.Tensor]] = None,
                       pgd_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Attacked VQA: the PGD image and / or the attacked text; with both, the
    text rides on the PGD image (reference :821-823).  ``pgd_fn(batch,
    vqa_targets) -> delta``."""
    b = dict(batch)
    if image_view and pgd_fn is not None:
        b["image"] = batch["image"] + pgd_fn(batch, batch["vqa_targets"]).detach()
    logits, targets, loss = _vqa_outputs(model, _with_text(b, attacked_text), block_matrices,
                                         train, seeds)
    # keys apart from the clean task's, so that a configuration running both
    # keeps them apart
    return {"vqa_attacked_loss": loss, "vqa_attacked_logits": logits,
            "vqa_attacked_loss_ps": bce_rowsum_with_logits(logits, targets),
            "vqa_targets": targets}


# ----------------------------------------------------------------- NLVR2
def nlvr2_logits(model, batch, block_matrices=None, train: bool = False, seeds=None):
    """The NLVR2 classifier on the class features of the text with image_0
    (token type 1) and with image_1 (token type 2), concatenated."""
    feats = [_infer(model, batch, block_matrices, train,
                    None if seeds is None else seeds[i], image_token_type_idx=i + 1)["cls_feats"]
             for i in range(2)]
    return model.nlvr2_classifier(torch.cat(feats, dim=-1))


def _ce(logits, labels, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}_loss": cross_entropy(logits, labels),
            f"{name}_loss_ps": cross_entropy_per_sample(logits, labels)[0]}


def compute_nlvr2(model, batch, *, seeds=None, block_matrices=None,
                  train: bool = False) -> Dict[str, torch.Tensor]:
    logits = nlvr2_logits(model, batch, block_matrices, train, seeds)
    labels = batch["answers"].long()
    return {**_ce(logits, labels, "nlvr2"), "nlvr2_logits": logits, "nlvr2_labels": labels,
            "nlvr2_step_accuracy": (logits.argmax(-1) == labels).float().mean()}


def compute_nlvr2_attack(model, batch, *, seeds=None, block_matrices=None,
                         train: bool = False, image_view: bool = False,
                         attacked_text: Optional[Dict[str, torch.Tensor]] = None,
                         pgd_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """The clean pass and, when a view is on, the attacked pass (the PGD
    images and / or the attacked text) on the clean pass's dropout seeds.
    ``pgd_fn(batch, labels) -> (delta_0, delta_1)``."""
    labels = batch["answers"].long()
    ret: Dict[str, torch.Tensor] = {"nlvr2_labels": labels}
    ori = nlvr2_logits(model, batch, block_matrices, train, seeds)
    ret["nlvr2_original_logits"] = ori
    ret.update(_ce(ori, labels, "nlvr2_original"))

    b = dict(batch)
    pgd = image_view and pgd_fn is not None
    if pgd:
        d0, d1 = (d.detach() for d in pgd_fn(batch, labels))
        b["image_0"], b["image_1"] = batch["image_0"] + d0, batch["image_1"] + d1
        ret["pgd_delta"] = 0.5 * (torch.linalg.vector_norm(d0.float(), dim=-1).mean()
                                  + torch.linalg.vector_norm(d1.float(), dim=-1).mean())
    if pgd or attacked_text is not None:
        att = nlvr2_logits(model, _with_text(b, attacked_text), block_matrices, train, seeds)
        ret["nlvr2_attacked_logits"] = att
        ret.update(_ce(att, labels, "nlvr2_attacked"))
        # the share of predictions the attack flipped
        ret["nlvr2_flip_rate"] = (att.argmax(-1) != ori.argmax(-1)).float().mean()
    return ret


# ------------------------------------------------------------------ IRTR
def stacked_text(batch, false_len: int):
    """(B, F+1, T) ids and masks: the true text at slot 0, then
    ``false_text_{i}``."""
    ids = [batch["text_ids"]] + [batch[f"false_text_{i}_ids"] for i in range(false_len)]
    masks = [batch["text_masks"]] + [batch[f"false_text_{i}_masks"] for i in range(false_len)]
    return torch.stack(ids, 1), torch.stack(masks, 1)


def irtr_scores(model, batch, head_fn: Callable, false_len: int, block_matrices=None,
                train: bool = False, seeds=None) -> torch.Tensor:
    """(B, F+1) scores of the joint forward of B * (F+1) pairs, each image
    embedded once (no dropout) and broadcast over its texts."""
    ids, masks = stacked_text(batch, false_len)
    B, F1, T = ids.shape
    tr = model.transformer
    ie, im = tr.visual_embed(batch["image"], model.grid_hw, model.max_image_len,
                             model.compute_dtype)
    L, C = ie.shape[1:]
    ie = ie[:, None].expand(B, F1, L, C).reshape(B * F1, L, C)
    im = im[:, None].expand(B, F1, L).reshape(B * F1, L)
    flat = {"text_ids": ids.reshape(B * F1, T), "text_masks": masks.reshape(B * F1, T)}
    infer = _infer(model, flat, block_matrices, train, None if seeds is None else seeds[0],
                   image_embeds=ie, image_masks=im)
    return head_fn(infer["cls_feats"])[:, 0].reshape(B, F1)


def compute_irtr(model, batch, *, seeds=None, block_matrices=None, train: bool = False,
                 false_len: int = 15) -> Dict[str, torch.Tensor]:
    score = irtr_scores(model, batch, model.rank_output, false_len, block_matrices, train,
                        seeds)
    answer = torch.zeros(score.shape[0], dtype=torch.long, device=score.device)
    return {**_ce(score, answer, "irtr"), "irtr_logits": score, "irtr_labels": answer,
            "irtr_step_accuracy": (score.argmax(-1) == 0).float().mean()}


def irtr_text_repr(model, batch, block_matrices=None) -> torch.Tensor:
    """(B, 128) normalised MoCo projections of each pair's deterministic
    forward: the text side of the IRTR attacks."""
    with torch.no_grad():
        cls = model.infer(batch, block_matrices)["cls_feats"]
        return l2_normalize(model.moco_head(cls), dim=1)


def irtr_text_panel(model, batch, block_matrices=None) -> Tuple[torch.Tensor, int]:
    """The text side of the training step's IRTR attacks, whose InfoNCE
    takes the batch's other texts as its negatives: the projections of the
    global batch (``irtr_text_repr`` of every rank's pairs in rank order, as
    the JAX package's pjit step sees them; this rank's alone without a
    process group) and the row of this rank's first pair among them."""
    return (gather_rows(irtr_text_repr(model, batch, block_matrices)),
            data_rank() * batch["text_ids"].shape[0])


def compute_irtr_attacked(model, batch, *, seeds=None, block_matrices=None,
                          train: bool = False, false_len: int = 15,
                          image_view: bool = False,
                          attacked_text: Optional[Dict[str, torch.Tensor]] = None,
                          pgd_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Attacked IRTR scored by ``moco_head[:, 0]`` (reference :1092), clean
    and, when a view is on, attacked on the clean pass's seeds.
    ``pgd_fn(batch, text_repr, row0) -> delta`` (the repaired IRTR PGD,
    pushing each pair's joint projection away from its own text's, on
    ``irtr_text_panel``'s texts of the global batch)."""
    score = irtr_scores(model, batch, model.moco_head, false_len, block_matrices, train, seeds)
    answer = torch.zeros(score.shape[0], dtype=torch.long, device=score.device)
    ret: Dict[str, torch.Tensor] = {**_ce(score, answer, "irtr_original"),
                                    "irtr_original_logits": score, "irtr_labels": answer}
    b = dict(batch)
    pgd = image_view and pgd_fn is not None
    if pgd:
        b["image"] = batch["image"] + pgd_fn(
            batch, *irtr_text_panel(model, batch, block_matrices)).detach()
    if pgd or attacked_text is not None:
        att = irtr_scores(model, _with_text(b, attacked_text), model.moco_head, false_len,
                          block_matrices, train, seeds)
        ret.update(_ce(att, answer, "irtr_attacked"))
        ret["irtr_attacked_logits"] = att
    return ret
