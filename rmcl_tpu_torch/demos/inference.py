"""Demo inference core (port of ``rmcl_tpu/demos/inference.py``; reference
demo.py:34-160, demo_vqa.py:30-80), independent of any UI, so that the
gradio apps are thin shells and tests can drive it.

Three capabilities:
  * iterative [MASK] filling through the MLM head: each pass commits the
    single most confident masked position (reference demo.py:70-84);
  * the IPOT word-patch-alignment heatmap of one token: its row of the
    transport plan scattered back onto the patch grid (reference
    demo.py:96-151; ``objectives/ot.py``);
  * VQA answering: the VQA classifier's softmax, best first, through
    ``id2answer`` (reference demo_vqa.py:57-78).

The engine runs the port's ``ViLT.infer`` under ``torch.no_grad()`` on its
device (the first CUDA device unless the caller passes ``device="cpu"``,
which runs the plain ops), with the block weights cast once, as
``serve.Session`` does.  An image is a PIL image (``prepare_image``; PIL is
imported where it is read) or an already prepared (1, H, W, 3) canvas.
The heatmap's grid is the canvas's: (H // P, W // P).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rmcl_tpu_torch.data.transforms import min_max_resize, to_normalized_array
from rmcl_tpu_torch.objectives.ot import cost_matrix_cosine, ipot


def prepare_image(image, cfg) -> np.ndarray:
    """PIL -> (1, H, W, 3) canvas-padded normalized array."""
    longer = int((1333 / 800) * cfg.image_size)
    arr = to_normalized_array(
        min_max_resize(image, shorter=cfg.image_size, longer=longer))
    H, W = cfg.image_bucket_hw
    canvas = np.zeros((1, H, W, 3), np.float32)
    h, w = min(arr.shape[0], H), min(arr.shape[1], W)
    canvas[0, :h, :w] = arr[:h, :w]
    return canvas


class DemoEngine:
    def __init__(self, cfg, model, tokenizer,
                 id2answer: Optional[Dict[int, str]] = None, device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.id2answer = id2answer or {}
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run the demo on a GPU, or pass "
                               "--device cpu to run the plain ops on the CPU")
        self.model = model.to(self.device).eval()
        with torch.no_grad():
            self.block_matrices = self.model.transformer.block_matrices(
                self.model.compute_dtype)

    # ------------------------------------------------------------ helpers
    def _canvas(self, image) -> np.ndarray:
        if isinstance(image, np.ndarray):
            return image
        return prepare_image(image, self.cfg)

    def _text_batch(self, text: str, img: np.ndarray) -> Dict[str, torch.Tensor]:
        enc = self.tokenizer([text], max_length=self.cfg.max_text_len,
                             return_tensors="np")
        ids = torch.from_numpy(np.asarray(enc["input_ids"], np.int32)).to(self.device)
        return {
            "image": torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device),
            "text_ids": ids,
            "text_labels": ids,
            "text_masks": torch.from_numpy(
                np.asarray(enc["attention_mask"], np.int32)).to(self.device),
        }

    def _infer(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self.model.infer(batch, self.block_matrices)

    # ---------------------------------------------------------- mlm fill
    def mlm_fill(self, image, masked_text: str) -> Tuple[str, List[str]]:
        """Fill every [MASK], most-confident-first.  Returns the final
        text and the per-step intermediate strings."""
        img = self._canvas(image)
        mask_id = self.tokenizer.mask_token_id
        n_masks = len(re.findall(r"\[MASK\]", masked_text))
        current = masked_text
        steps = [current]
        for _ in range(n_masks):
            batch = self._text_batch(current, img)
            with torch.no_grad():
                logits = self.model.mlm_score(self._infer(batch)["text_feats"])[0]
                probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
            ids = batch["text_ids"][0].cpu().numpy()
            n = len(ids)
            best_val = probs[:n].max(axis=-1)
            best_id = probs[:n].argmax(axis=-1)
            best_val[ids != mask_id] = 0.0
            if best_val.max() == 0.0:
                break
            pos = int(best_val.argmax())
            ids = ids.copy()
            ids[pos] = best_id[pos]
            current = self.tokenizer.decode(ids, skip_special_tokens=True)
            steps.append(current)
        return current, steps

    # ----------------------------------------------------------- heatmap
    def wpa_heatmap(self, image, text: str, token_idx: int,
                    ot_iterations: int = 100) -> Tuple[np.ndarray, str]:
        """IPOT transport-plan heatmap for token ``token_idx`` (position in
        the tokenized text incl. CLS).  Returns (heatmap (gh, gw), token)."""
        img = self._canvas(image)
        batch = self._text_batch(text, img)
        infer = self._infer(batch)

        txt_emb = infer["text_feats"].float()
        img_emb = infer["image_feats"].float()
        txt_mask = infer["text_masks"].bool().clone()
        img_mask = infer["image_masks"].bool().clone()
        lens = txt_mask.sum(dim=1)
        txt_mask[torch.arange(len(lens), device=lens.device), lens - 1] = False
        txt_mask[:, 0] = False
        img_mask[:, 0] = False
        txt_pad, img_pad = ~txt_mask, ~img_mask

        cost = cost_matrix_cosine(txt_emb, img_emb)
        joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
        cost = torch.where(joint_pad, 0.0, cost)
        txt_len = (txt_pad.shape[1] - txt_pad.sum(1)).float()
        img_len = (img_pad.shape[1] - img_pad.sum(1)).float()
        T = ipot(cost, txt_len, txt_pad, img_len, img_pad, joint_pad,
                 0.1, ot_iterations, 1)

        plan = T[0].cpu().numpy() * txt_emb.shape[0]     # (img, txt)
        row = plan.T[token_idx][1:]                       # drop image CLS
        P = self.cfg.patch_size
        gh, gw = img.shape[1] // P, img.shape[2] // P
        pidx = infer["patch_index"][0].cpu().numpy()
        heat = np.zeros((gh, gw), np.float32)
        for i in range(min(len(row), pidx.shape[0])):
            heat[pidx[i, 0], pidx[i, 1]] = row[i]
        std = heat.std() or 1.0
        heat = (heat - heat.mean()) / std
        heat = np.clip(heat, 1.0, 3.0)
        rng = heat.max() - heat.min() or 1.0
        heat = (heat - heat.min()) / rng
        ids = self.tokenizer([text], max_length=self.cfg.max_text_len,
                             return_tensors="np")["input_ids"][0]
        token = self.tokenizer.convert_ids_to_tokens(int(ids[token_idx]))
        return heat, token

    # --------------------------------------------------------------- vqa
    def answer(self, image, question: str,
               topk: int = 5) -> List[Tuple[str, float]]:
        img = self._canvas(image)
        batch = self._text_batch(question, img)
        with torch.no_grad():
            logits = self.model.vqa_classifier(self._infer(batch)["cls_feats"])[0]
            probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        top = np.argsort(-probs)[:topk]
        return [(self.id2answer.get(int(i), f"label_{int(i)}"),
                 float(probs[i])) for i in top]
