"""Golden-tensor parity harness (port of ``rmcl_tpu/compat/golden.py``).

Workflow:
  1. With the reference model and a published checkpoint, run a pinned
     (image, caption) batch and dump its features with ``save_golden`` (a
     plain ``.npz`` of the pinned inputs and the outputs, and an optional
     ``.json`` of notes).
  2. ``compare_golden`` replays the same inputs through the port's
     ``ViLT.infer`` (deterministic) and reports each tensor's max-abs-error
     against the dump.

The batch is pinned because the reference's results vary with the padded
batch's composition (reference EVAL.md:2); the file keeps the exact
post-transform pixels, channels last (B, H, W, 3), which ``ViLT.infer`` reads
as the HWC canvas (``models/vit.py:as_patch_rows``).  ``save_golden`` and
``load_golden`` are numpy only, so a file written by the JAX package's
harness replays here and the other way round.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

GOLDEN_KEYS = ("text_feats", "image_feats", "cls_feats")


def save_golden(path: str, batch: Dict[str, np.ndarray],
                outputs: Dict[str, np.ndarray],
                meta: Optional[Dict[str, Any]] = None):
    """Dump pinned inputs + reference outputs.  ``batch`` must contain the
    post-transform image tensor (B, H, W, 3 channels-last) and the
    tokenized text_ids/text_masks."""
    arrays = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            arrays[f"in_{k}"] = v
    for k in GOLDEN_KEYS:
        if k in outputs:
            arrays[f"out_{k}"] = np.asarray(outputs[k], np.float32)
    np.savez_compressed(path, **arrays)
    if meta:
        with open(path + ".json", "w") as fp:
            json.dump(meta, fp, indent=2)


def load_golden(path: str) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, np.ndarray]]:
    data = np.load(path)
    batch = {k[3:]: data[k] for k in data.files if k.startswith("in_")}
    outputs = {k[4:]: data[k] for k in data.files if k.startswith("out_")}
    return batch, outputs


def compare_golden(path: str, model, atol: float = 5e-3) -> Dict[str, float]:
    """Replay the pinned batch through ``model.infer`` where the model's
    parameters are; returns {key: max_abs_err} and raises if any exceeds
    atol."""
    batch, golden = load_golden(path)
    device = next(model.parameters()).device
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    if "text_labels" not in tb:
        tb["text_labels"] = torch.full_like(tb["text_ids"], -100)
    with torch.no_grad():
        out = model.infer(tb)
    errs = {}
    for k, ref in golden.items():
        got = out[k].float().cpu().numpy()
        errs[k] = float(np.max(np.abs(got - ref)))
    bad = {k: e for k, e in errs.items() if e > atol}
    if bad:
        raise AssertionError(f"golden mismatch beyond atol={atol}: {bad} "
                             f"(all: {errs})")
    return errs
