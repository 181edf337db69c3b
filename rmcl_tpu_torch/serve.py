"""Serving (port of ``rmcl_tpu/serve.py``): one task's deterministic
inference over fixed-size wire-format batches.

Where the JAX package serves an exported StableHLO artifact, the port
serves the live ``ViLT`` module: ``Session`` holds it on one device with
its block weights cast once to the compute type, chunks requests into
batches of the session's size and pads a short chunk by repeating its
first request (padded rows are dropped before returning), as
``ArtifactSession`` does.  Outputs are float32 numpy arrays;
``postprocess`` turns them into response records.

Tasks:
  mlm   -> (B, T, vocab) logits
  itm   -> (B, 2) match logits
  rank  -> (B,) rank_output score
  vqa   -> (B, vqav2_label_size) logits
  embed -> (B, 128) l2-normalised MoCo projection
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rmcl_tpu_torch.models.vilt import ViLT

TASKS = ("mlm", "itm", "rank", "vqa", "embed")
REQUIRED_HEAD = {"mlm": "mlm_score", "itm": "itm_score", "rank": "rank_output",
                 "vqa": "vqa_classifier", "embed": "moco_head"}


def build_infer_fn(cfg, task: str) -> Callable:
    """``(model, batch, block_matrices=None) -> task output`` on the batch's device."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")

    def f(model: ViLT, batch: Dict[str, torch.Tensor], block_matrices=None):
        inf = model.infer(batch, block_matrices)
        if task == "mlm":
            return model.mlm_score(inf["text_feats"])
        if task == "itm":
            return model.itm_score(inf["cls_feats"])
        if task == "rank":
            return model.rank_output(inf["cls_feats"])[:, 0]
        if task == "vqa":
            return model.vqa_classifier(inf["cls_feats"])
        z = model.moco_head(inf["cls_feats"])
        return F.normalize(z.float(), dim=1, eps=1e-12).to(z.dtype)

    return f


def batch_spec(cfg, batch_size: int) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """Wire-format input signature: name -> (shape, numpy dtype)."""
    if cfg.image_layout != "patch":
        raise ValueError("the port serves the patch-row wire format "
                         "(image_layout='patch')")
    B, T = batch_size, cfg.max_text_len
    gh, gw = cfg.grid_hw
    u8 = cfg.image_dtype == "uint8"
    spec = {"image": ((B, gh * gw, cfg.patch_size ** 2 * 3),
                      np.dtype(np.uint8 if u8 else np.float32)),
            "text_ids": ((B, T), np.dtype(np.int32)),
            "text_masks": ((B, T), np.dtype(np.int32))}
    if u8:
        spec["image_hw"] = ((B, 2), np.dtype(np.int32))
    return spec


class Session:
    """One task served by one model on one device at a fixed batch size."""

    def __init__(self, cfg, model: ViLT, task: str, batch_size: int,
                 device: torch.device, tokenizer=None):
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if not hasattr(model, REQUIRED_HEAD[task]):
            raise ValueError(f"the model has no {REQUIRED_HEAD[task]!r} head: serve "
                             f"{task!r} from a config whose loss_names activate it")
        self.cfg, self.task, self.batch_size = cfg, task, batch_size
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.spec = batch_spec(cfg, batch_size)
        self.fn = build_infer_fn(cfg, task)
        with torch.inference_mode():
            self.block_matrices = self.model.transformer.block_matrices(
                self.model.compute_dtype)
        self._transform = None

    # ------------------------------------------------------------ batches
    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One full wire-format batch -> the task output on the device."""
        for k, (shape, dtype) in self.spec.items():
            v = batch[k]
            if v.shape != shape or v.dtype != dtype:
                raise ValueError(f"{k}: expected {shape} {dtype}, got "
                                 f"{v.shape} {v.dtype}")
        t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device)
             for k in self.spec}
        with torch.inference_mode():
            return self.fn(self.model, t, self.block_matrices)

    def infer(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """n wire-format requests (leading axis n) -> (n, ...) float32 outputs,
        in chunks of the session's batch size."""
        n = len(batch["text_ids"])
        if n == 0:
            raise ValueError("infer() needs at least one request")
        B, outs = self.batch_size, []
        for i in range(0, n, B):
            chunk = {k: batch[k][i:i + B] for k in self.spec}
            m = len(chunk["text_ids"])
            if m < B:   # pad by repeating the chunk's first request
                chunk = {k: np.concatenate([v, np.repeat(v[:1], B - m, axis=0)])
                         for k, v in chunk.items()}
            outs.append(self.forward(chunk).float().cpu().numpy()[:m])
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------- raw requests
    def _prep_image(self, image) -> np.ndarray:
        """PIL image or HWC uint8 array -> resized array in the wire dtype,
        fitted to the bucket (``ArtifactSession._prep_image``)."""
        from PIL import Image

        from rmcl_tpu_torch.data import transforms as tr
        cfg = self.cfg
        if self._transform is None:
            self._transform = tr.pixelbert_transform(
                size=cfg.image_size, bucket_hw=tuple(cfg.image_bucket_hw),
                out_dtype=cfg.image_dtype)
        if isinstance(image, np.ndarray):
            image = Image.fromarray(image)
        longer = int((1333 / 800) * cfg.image_size)
        w, h = image.size
        neww, newh = tr.min_max_size(w, h, cfg.image_size, longer)
        if neww < 32 or newh < 32:
            # extreme aspect ratios: clamp to one patch instead of refusing
            img = tr.fit_bucket(image.resize((max(neww, 32), max(newh, 32)),
                                             Image.BICUBIC),
                                tuple(cfg.image_bucket_hw))
            if cfg.image_dtype == "uint8":
                return np.asarray(img.convert("RGB"), np.uint8)
            return tr.to_normalized_array(img)
        return self._transform(image)

    def assemble(self, images: Sequence, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        """Raw requests -> wire-format batch (leading axis = len(images))."""
        from rmcl_tpu_torch.data.patch_rows import images_to_patch_rows as to_rows
        if self.tokenizer is None:
            raise ValueError("raw requests need a tokenizer")
        H, W = self.cfg.image_bucket_hw
        arrs = [self._prep_image(im) for im in images]
        enc = self.tokenizer(list(texts), max_length=self.cfg.max_text_len,
                             padding="max_length", truncation=True,
                             return_tensors="np")
        batch = {"image": to_rows(arrs, H, W, self.cfg.patch_size),
                 "text_ids": np.asarray(enc["input_ids"], np.int32),
                 "text_masks": np.asarray(enc["attention_mask"], np.int32)}
        if self.cfg.image_dtype == "uint8":
            batch["image_hw"] = np.asarray(
                [[min(a.shape[0], H), min(a.shape[1], W)] for a in arrs], np.int32)
        return batch

    def predict(self, images: Sequence, texts: Sequence[str]) -> np.ndarray:
        """n raw requests (PIL images or HWC uint8 arrays, strings) -> (n, ...)."""
        if len(images) != len(texts):
            raise ValueError("images and texts must pair 1:1")
        if not images:
            raise ValueError("predict() needs at least one request")
        return self.infer(self.assemble(images, texts))


def postprocess(task: str, out, tokenizer=None, text_ids=None,
                topk: int = 5) -> List[Dict]:
    """Raw task outputs -> JSON-serializable per-request records (the
    `rmcl serve` response format)."""
    out = np.asarray(out, np.float32)
    recs: List[Dict] = []
    for i in range(out.shape[0]):
        if task == "itm":
            p = np.exp(out[i] - out[i].max())
            p /= p.sum()
            recs.append({"match_prob": float(p[1])})
        elif task == "rank":
            recs.append({"score": float(out[i])})
        elif task == "embed":
            recs.append({"embedding": [float(x) for x in out[i]]})
        elif task == "vqa":
            p = np.exp(out[i] - out[i].max())
            p /= p.sum()
            top = np.argsort(-p)[:topk]
            recs.append({"answers": [[int(j), float(p[j])] for j in top]})
        else:  # mlm: argmax token at each [MASK] position
            ids = np.asarray(text_ids[i])
            mask_id = tokenizer.mask_token_id
            pos = np.where(ids == mask_id)[0]
            pred = out[i].argmax(axis=-1)
            recs.append({"fills": [
                [int(p_), tokenizer.convert_ids_to_tokens(int(pred[p_]))]
                for p_ in pos]})
    return recs


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``torch.save``d reference-named state dict, plain or under
    ``"state_dict"`` as in a Lightning checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)


def seeded_model(cfg, seed: Optional[int] = None) -> ViLT:
    """A ViLT for ``cfg`` with weights drawn from ``seed`` (default cfg.seed)."""
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return ViLT(cfg).init(g)
