"""Host-side image transform of the serving path: the pixelbert resize.

The port's own copy of what serving uses from the JAX package's
``data/transforms.py`` (behavioural spec: reference
vilt/transforms/{utils.py,pixelbert.py}); pure PIL + numpy.  RandAugment is
a training-time transform and comes with the training data pipeline; that
package's optional C++ resize gives the same bytes as the PIL path kept here.

Output convention: channels-LAST (H, W, 3), float32 normalised
``(x/255 - 0.5)/0.5`` or raw uint8 for the u8 wire format.

Static shapes: the reference pads each batch to the batch max H x W
(reference base_dataset.py:184-206).  Here each image additionally fits
inside the configured static bucket: if a resized image exceeds the bucket
on either side it is rescaled to fit (same /32-rounding rules).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
from PIL import Image


def min_max_size(w: int, h: int, shorter: int, longer: int) -> Tuple[int, int]:
    """(new_w, new_h) after MinMaxResize rules (reference
    vilt/transforms/utils.py:5-27): scale shorter side to `shorter`, cap
    longer side at `longer`, round half-up then floor to /32."""
    scale = shorter / min(w, h)
    if h < w:
        newh, neww = shorter, scale * w
    else:
        newh, neww = scale * h, shorter
    if max(newh, neww) > longer:
        s2 = longer / max(newh, neww)
        newh, neww = newh * s2, neww * s2
    newh, neww = int(newh + 0.5), int(neww + 0.5)
    return (neww // 32 * 32, newh // 32 * 32)


def min_max_resize(img: Image.Image, shorter: int = 800,
                   longer: int = 1333) -> Image.Image:
    w, h = img.size
    neww, newh = min_max_size(w, h, shorter, longer)
    return img.resize((neww, newh), resample=Image.BICUBIC)


def fit_bucket(img: Image.Image, bucket_hw: Tuple[int, int]) -> Image.Image:
    """If the resized image exceeds the static bucket, rescale to fit
    (keep aspect, /32 floor)."""
    bh, bw = bucket_hw
    w, h = img.size
    if w <= bw and h <= bh:
        return img
    s = min(bw / w, bh / h)
    neww = max(int(w * s) // 32 * 32, 32)
    newh = max(int(h * s) // 32 * 32, 32)
    return img.resize((neww, newh), resample=Image.BICUBIC)


def to_normalized_array(img: Image.Image) -> np.ndarray:
    """(H, W, 3) float32 in [-1, 1]: ToTensor + inception_normalize
    (reference transforms/utils.py:46-49)."""
    return normalize_u8_array(np.asarray(img.convert("RGB"), np.uint8))


def normalize_u8_array(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 (x/255 - 0.5)/0.5, in exactly this f32 op order:
    the device normalise (models/vit.py:normalize_u8) repeats it, which is
    what makes the u8 wire format bit-identical to the float32 one."""
    return (arr.astype(np.float32) / 255.0 - 0.5) / 0.5


def pixelbert_transform(size: int = 800,
                        bucket_hw: Optional[Tuple[int, int]] = None,
                        out_dtype: str = "float32") -> Callable:
    """PIL -> (H, W, 3) float32 in [-1, 1] (reference pixelbert.py:8-30),
    or raw uint8 when out_dtype="uint8" (normalised on the device)."""
    longer = int((1333 / 800) * size)

    def tr(img: Image.Image) -> np.ndarray:
        img = min_max_resize(img, shorter=size, longer=longer)
        if bucket_hw is not None:
            img = fit_bucket(img, bucket_hw)
        if out_dtype == "uint8":
            return np.ascontiguousarray(
                np.asarray(img.convert("RGB"), np.uint8))
        return to_normalized_array(img)

    return tr
