"""IR/TR recall evaluation (port of the JAX package's ``eval/retrieval.py``;
reference objectives.py compute_irtr_recall:1225-1346 and
compute_attacked_irtr_recall:1348-1502).

Each image is embedded once; its score row is the rank output of the joint
forward of that embedding with every text, ``txt_chunk`` texts per forward;
recall@k in both directions comes from the (n_img, n_txt) score matrix at the
end.  The texts run at the smallest /8 bucket that holds every caption
(``cfg.eval_text_bucket``; exact: the dropped columns are padding, masked).
The attacked variant perturbs the texts (the greedy IRTR attack) and each
image (the IRTR PGD) before ranking them, and ranks the attacked inputs.

The JAX package embeds an (H, W, 3) canvas, the image placed top-left on
zeros; the port lays the same canvas out as patch rows
(``data/patch_rows.py``), whose validity mask follows the same rule (a
patch is valid when its top-left pixel is not all zero), and runs the image
PGD on those rows.  Over several processes the image rows are sharded
(``rank::world``) and every rank's score rows gathered
(``parallel/comm.py:all_gather``) into the whole matrix on every rank.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rmcl_tpu_torch.core.buckets import bucket_enabled, text_bucket
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.data.transforms import normalize_u8_array
from rmcl_tpu_torch.objectives.downstream import irtr_text_repr
from rmcl_tpu_torch.parallel import comm


def recall_at_k(scores: np.ndarray, iids: np.ndarray, tiids: np.ndarray
                ) -> Tuple[float, ...]:
    """scores: (n_img, n_txt); iids: the image id of each row; tiids: the
    image id each text belongs to.  Returns (ir_r1, ir_r5, ir_r10, tr_r1,
    tr_r5, tr_r10), as reference objectives.py:1324-1344 defines them; of
    equal scores the lower index ranks first (``lax.top_k``'s order), and
    each share is the hit count times 1/n in float32, as the JAX package's
    compiled mean computes it."""
    s = np.asarray(scores)
    iid, tiid = np.asarray(iids), np.asarray(tiids)

    def top(m, k):
        return np.argsort(-m, axis=1, kind="stable")[:, :min(k, m.shape[1])]

    def share(hit):
        n = np.float32(hit.shape[0])
        return float(np.float32(hit.any(axis=1).sum()) * (np.float32(1) / n))

    def tr(k):       # text retrieval: for each image (row), rank the texts
        return share(tiid[top(s, k)] == iid[:, None])

    def ir(k):       # image retrieval: for each text (column), rank the images
        return share(iid[top(s.T, k)] == tiid[:, None])

    return (ir(1), ir(5), ir(10), tr(1), tr(5), tr(10))


def image_rows(cfg, img: np.ndarray) -> np.ndarray:
    """One sample's image (h, w, 3), u8 or normalised float, on the zero
    (H, W) bucket canvas, as (1, N, P*P*3) float32 patch rows."""
    if img.dtype == np.uint8:
        img = normalize_u8_array(img)
    H, W = cfg.image_bucket_hw
    canvas = np.zeros((1, H, W, 3), np.float32)
    canvas[0, :img.shape[0], :img.shape[1]] = img[:H, :W]
    return hwc_to_patch_rows(canvas, cfg.patch_size)


def compute_irtr_recall(trainer, dataset_name: Optional[str] = None, split: str = "test",
                        txt_chunk: int = 256, max_texts: Optional[int] = None,
                        max_images: Optional[int] = None, verbose: bool = True,
                        attack_text_fn: Optional[Callable] = None,
                        attack_image_fn: Optional[Callable] = None,
                        shard_by_process: bool = True):
    """Full cross-product IR/TR recall from ``rank_output`` scores.

    ``trainer``: a ``Trainer`` after ``setup`` (its config, model, block
    matrices and datamodule are read).  ``attack_text_fn(ids, masks) ->
    (ids, masks)`` and ``attack_image_fn(rows) -> rows`` perturb the inputs
    before ranking (``compute_attacked_irtr_recall``).  With several
    processes and ``shard_by_process``, each ranks the image rows
    ``rank::world`` (attacked where ``attack_image_fn`` is given) and the
    score rows are gathered; every rank returns the recall of the whole
    matrix.  Returns the recall tuple."""
    cfg = trainer.cfg
    model = trainer.ts.model
    if not hasattr(model, "rank_output"):
        # the JAX package and the reference fail here too (a KeyError, an
        # AttributeError): task_finetune_irtr_coco_randaug_attacked builds no
        # rank_output
        raise ValueError("the recall ranks pairs by rank_output, which only a model "
                         "with the irtr loss builds: add irtr to loss_names")
    mats = trainer.ts.block_matrices
    dev = next(model.parameters()).device
    name = dataset_name or cfg.datasets[0]
    dset = trainer.dm.make_no_false_dset(name, split)

    # ---- 1. every text, encoded once
    n_txt = len(dset) if not max_texts else min(len(dset), max_texts)
    text_ids = np.zeros((n_txt, cfg.max_text_len), np.int32)
    text_masks = np.zeros((n_txt, cfg.max_text_len), np.int32)
    tiids = np.zeros((n_txt,), np.int64)
    for i in range(n_txt):
        t = dset.get_text(i)
        text_ids[i] = np.asarray(t["text"][1]["input_ids"])
        text_masks[i] = np.asarray(t["text"][1]["attention_mask"])
        tiids[i] = t["img_index"]

    # ---- 2. the images the texts belong to
    img_rows = sorted(set(int(i) for i in tiids))
    if max_images:
        img_rows = img_rows[:max_images]
        keep = np.isin(tiids, img_rows)
        text_ids, text_masks, tiids = text_ids[keep], text_masks[keep], tiids[keep]
        n_txt = len(tiids)
    iids = np.asarray(img_rows, np.int64)

    if attack_text_fn is not None:
        text_ids, text_masks = attack_text_fn(text_ids, text_masks)
    # the smallest /8 bucket over every caption, after the attack (which can
    # lengthen a caption)
    if bucket_enabled(cfg, "eval") and n_txt:
        tb = text_bucket(int(text_masks.sum(axis=1).max()), cfg.max_text_len)
        text_ids, text_masks = text_ids[:, :tb], text_masks[:, :tb]
    ids_all = torch.from_numpy(np.ascontiguousarray(text_ids)).to(dev)
    masks_all = torch.from_numpy(np.ascontiguousarray(text_masks)).to(dev)

    # ---- 3. images outer (embedded once), text chunks inner
    row_to_sample = {}
    for i, (row, _) in dset.index_mapper.items():
        row_to_sample.setdefault(row, i)
    scores = torch.zeros((len(img_rows), n_txt), dtype=torch.float32, device=dev)
    tr = model.transformer
    t0 = time.time()
    world, rank = comm.get_world_size(), comm.get_rank()
    mine = (range(rank, len(img_rows), world) if shard_by_process and world > 1
            else range(len(img_rows)))
    for ii in mine:
        row = img_rows[ii]
        rows = image_rows(cfg, dset.get_image(row_to_sample[row])["image"][0])
        if attack_image_fn is not None:
            rows = attack_image_fn(rows)
        with torch.no_grad():
            ie, im = tr.visual_embed(torch.as_tensor(rows, device=dev), model.grid_hw,
                                     model.max_image_len, model.compute_dtype)
            for s in range(0, n_txt, txt_chunk):
                e = min(s + txt_chunk, n_txt)
                n = e - s
                infer = model.infer({"text_ids": ids_all[s:e], "text_masks": masks_all[s:e]},
                                    mats, image_embeds=ie.expand(n, *ie.shape[1:]),
                                    image_masks=im.expand(n, im.shape[1]))
                scores[ii, s:e] = model.rank_output(infer["cls_feats"])[:, 0].float()
        if verbose and (ii + 1) % 50 == 0:
            print(f"[recall] {ii + 1}/{len(img_rows)} images "
                  f"({(time.time() - t0) / (ii + 1):.2f}s/img)", flush=True)
    scores = scores.cpu().numpy()
    if shard_by_process and world > 1:
        for part in comm.all_gather({ii: scores[ii] for ii in mine}):
            for ii, row_scores in part.items():
                scores[ii] = row_scores
    return recall_at_k(scores, iids, tiids)


def compute_attacked_irtr_recall(trainer, dataset_name: Optional[str] = None,
                                 split: str = "test", max_texts: Optional[int] = 20 * 4,
                                 max_images: Optional[int] = None, text_view: bool = True,
                                 image_view: bool = True, **kw):
    """Attacked IR/TR recall (reference compute_attacked_irtr_recall
    :1348-1502, whose rank loop ignored the attacked inputs; here they are
    ranked).  The texts: the greedy IRTR attack (the trainer's attacker when
    it is IRTR's, else one built on its tokenizer and synonyms), 16 captions
    at a time, each against its own MoCo projection on a 0.5 canvas.  The
    images: the IRTR PGD, one image at a time, against the projection of an
    all-[PAD] text with every position attended.  ``max_texts`` caps the
    texts as the reference's 20-batch preload does (:1350, :1365)."""
    from rmcl_tpu_torch.attacks.greedy import GreedyAttackIrtr
    from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
    from rmcl_tpu_torch.attacks.pgd import make_pgd_irtr
    cfg = trainer.cfg
    model = trainer.ts.model
    mats = trainer.ts.block_matrices
    dev = next(model.parameters()).device
    H, W = cfg.image_bucket_hw

    def proxy_rows(n):        # the 0.5 canvas as patch rows
        return torch.full((n, (H // cfg.patch_size) * (W // cfg.patch_size),
                           cfg.patch_size ** 2 * 3), 0.5, device=dev)

    attack_text_fn = None
    greedy = getattr(trainer, "greedy", None)
    if text_view and greedy is not None:
        base = getattr(greedy, "base", greedy)
        irtr = greedy
        if not isinstance(base, GreedyAttackIrtr):
            irtr = GreedyAttackIrtr(cfg, model, base.tokenizer, base.synonyms)
            if isinstance(greedy, FusedGreedyAttack):
                irtr = FusedGreedyAttack(irtr)

        def attack_text_fn(ids, masks):
            out_ids, out_masks = ids.copy(), masks.copy()
            B = 16
            for s in range(0, len(ids), B):
                chunk = {"text_ids": torch.from_numpy(ids[s:s + B]).to(dev),
                         "text_masks": torch.from_numpy(masks[s:s + B]).to(dev)}
                chunk["image"] = proxy_rows(chunk["text_ids"].shape[0])
                tr_repr = irtr_text_repr(model, chunk, mats)
                extras = (tr_repr, cfg.temperature,
                          torch.arange(tr_repr.shape[0], device=dev))
                res = irtr.adv_attack_samples(chunk, extras)
                out_ids[s:s + B] = res["txt_input_ids"]
                out_masks[s:s + B] = res["text_masks"]
            return out_ids, out_masks

    attack_image_fn = None
    if image_view and hasattr(model, "moco_head"):
        pgd = make_pgd_irtr(model, cfg.adv_steps_img, cfg.adv_lr_img, cfg.adv_max_norm_img,
                            cfg.temperature)

        def attack_image_fn(rows):
            T = cfg.max_text_len
            batch = {"image": torch.as_tensor(rows, device=dev),
                     "text_ids": torch.zeros((1, T), dtype=torch.int32, device=dev),
                     "text_masks": torch.ones((1, T), dtype=torch.int32, device=dev)}
            delta = pgd(batch, irtr_text_repr(model, batch, mats), block_matrices=mats)
            return (batch["image"] + delta).cpu().numpy()

    return compute_irtr_recall(trainer, dataset_name=dataset_name, split=split,
                               max_texts=max_texts, max_images=max_images,
                               attack_text_fn=attack_text_fn, attack_image_fn=attack_image_fn,
                               **kw)
