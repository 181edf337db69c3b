"""Host-side relayout of images into the patch-row wire format (the port's
own copy of ``hwc_to_patch_rows`` / ``_images_to_patch_rows`` from the JAX
package's ``data/arrow_dataset.py``; numpy, and the C++ scatter where g++
is on PATH)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def hwc_to_patch_rows(canvas: np.ndarray, patch_size: int) -> np.ndarray:
    """(B, H, W, 3) -> (B, gh*gw, P*P*3) rows, (ph, pw, ch) flat order."""
    B, H, W, _ = canvas.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = canvas.reshape(B, gh, P, gw, P, 3)
    return np.ascontiguousarray(
        x.transpose(0, 1, 3, 2, 4, 5)).reshape(B, gh * gw, P * P * 3)


def images_to_patch_rows(imgs: Sequence[np.ndarray], H: int, W: int,
                         P: int) -> np.ndarray:
    """Per-sample (h, w, 3) images, top-left aligned on a zero (H, W) canvas,
    as patch rows.  Dtype follows the inputs (u8 wire format or normalised
    float32).  Where g++ is on PATH, the C++ scatter of
    ``data/_native/imageproc.cpp`` writes the rows without the canvas (the
    same bytes); else the canvas is relaid out in numpy."""
    dtype = np.uint8 if len(imgs) and imgs[0].dtype == np.uint8 else np.float32
    from rmcl_tpu_torch.data import _native
    lib = _native.load_imageproc()
    if lib is not None:
        out = np.zeros((len(imgs), (H // P) * (W // P), P * P * 3), dtype)
        for bi, im in enumerate(imgs):
            _native.image_to_patch_rows(lib, np.ascontiguousarray(im[:H, :W], dtype),
                                        H, W, P, out[bi])
        return out
    canvas = np.zeros((len(imgs), H, W, 3), dtype)
    for bi, im in enumerate(imgs):
        h, w = im.shape[:2]
        canvas[bi, :min(h, H), :min(w, W)] = im[:H, :W]
    return hwc_to_patch_rows(canvas, P)
