"""Host-side image transforms: the pixelbert resize and RandAugment.

The port's own copy of the JAX package's ``data/transforms.py`` (behavioural
spec: reference vilt/transforms/{utils.py,pixelbert.py,randaug.py}): PIL +
numpy, and where g++ is on PATH the C++ resize and normalisation of
``data/_native/imageproc.cpp`` (built at first use; the same bytes as the
PIL path).  PIL is imported where an image is touched, never at import, so
the modules that import this one import without it.

Output convention: channels-LAST (H, W, 3), float32 normalised
``(x/255 - 0.5)/0.5`` or raw uint8 for the u8 wire format.

Static shapes: the reference pads each batch to the batch max H x W
(reference base_dataset.py:184-206).  Here each image additionally fits
inside the configured static bucket: if a resized image exceeds the bucket
on either side it is rescaled to fit (same /32-rounding rules).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from rmcl_tpu_torch.data.rng import srandom


def _pil():
    from PIL import Image, ImageEnhance, ImageOps
    return Image, ImageEnhance, ImageOps


# ------------------------------------------------------------ resize math
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


def min_max_resize(img, shorter: int = 800, longer: int = 1333):
    w, h = img.size
    neww, newh = min_max_size(w, h, shorter, longer)
    return img.resize((neww, newh), resample=_pil()[0].BICUBIC)


def fit_bucket(img, bucket_hw: Tuple[int, int]):
    """If the resized image exceeds the static bucket, rescale to fit
    (keep aspect, /32 floor)."""
    bh, bw = bucket_hw
    w, h = img.size
    if w <= bw and h <= bh:
        return img
    s = min(bw / w, bh / h)
    neww = max(int(w * s) // 32 * 32, 32)
    newh = max(int(h * s) // 32 * 32, 32)
    return img.resize((neww, newh), resample=_pil()[0].BICUBIC)


def to_normalized_array(img) -> np.ndarray:
    """(H, W, 3) float32 in [-1, 1]: ToTensor + inception_normalize
    (reference transforms/utils.py:46-49)."""
    return normalize_u8_array(np.asarray(img.convert("RGB"), np.uint8))


def normalize_u8_array(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 (x/255 - 0.5)/0.5, in exactly this f32 op order:
    the device normalise (models/vit.py:normalize_u8) repeats it, which is
    what makes the u8 wire format bit-identical to the float32 one."""
    return (arr.astype(np.float32) / 255.0 - 0.5) / 0.5


# ------------------------------------------------------------- randaug ops
def _autocontrast(img, _):
    return _pil()[2].autocontrast(img)


def _equalize(img, _):
    return _pil()[2].equalize(img)


def _rotate(img, v):
    if srandom.random() > 0.5:
        v = -v
    return img.rotate(v)


def _posterize(img, v):
    return _pil()[2].posterize(img, max(1, int(v)))


def _solarize(img, v):
    return _pil()[2].solarize(img, int(v))


def _solarize_add(img, v, thresh=128):
    arr = np.asarray(img).astype(np.int64)
    out = np.where(arr < thresh, np.clip(arr + int(v), 0, 255), arr)
    return _pil()[0].fromarray(out.astype(np.uint8))


def _color(img, v):
    return _pil()[1].Color(img).enhance(v)


def _contrast(img, v):
    return _pil()[1].Contrast(img).enhance(v)


def _brightness(img, v):
    return _pil()[1].Brightness(img).enhance(v)


def _sharpness(img, v):
    return _pil()[1].Sharpness(img).enhance(v)


def _affine(img, coeffs):
    return img.transform(img.size, _pil()[0].AFFINE, coeffs)


def _shear_x(img, v):
    if srandom.random() > 0.5:
        v = -v
    return _affine(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    if srandom.random() > 0.5:
        v = -v
    return _affine(img, (1, 0, 0, v, 1, 0))


def _translate_x_abs(img, v):
    if srandom.random() > 0.5:
        v = -v
    return _affine(img, (1, 0, v, 0, 1, 0))


def _translate_y_abs(img, v):
    if srandom.random() > 0.5:
        v = -v
    return _affine(img, (1, 0, 0, 0, 1, v))


# active 14-op policy (reference randaug.py:181-201, TPU autoaugment list)
RANDAUG_OPS = [
    (_autocontrast, 0, 1),
    (_equalize, 0, 1),
    (_rotate, 0, 30),
    (_posterize, 0, 4),
    (_solarize, 0, 256),
    (_solarize_add, 0, 110),
    (_color, 0.1, 1.9),
    (_contrast, 0.1, 1.9),
    (_brightness, 0.1, 1.9),
    (_sharpness, 0.1, 1.9),
    (_shear_x, 0.0, 0.3),
    (_shear_y, 0.0, 0.3),
    (_translate_x_abs, 0.0, 100),
    (_translate_y_abs, 0.0, 100),
]


class RandAugment:
    """n ops at magnitude m/30 of each range (reference randaug.py:258-274),
    drawn from ``srandom`` (the loader's per-sample stream)."""

    def __init__(self, n: int = 2, m: int = 9):
        self.n, self.m = n, m

    def __call__(self, img):
        for op, lo, hi in srandom.choices(RANDAUG_OPS, k=self.n):
            v = (self.m / 30.0) * (hi - lo) + lo
            img = op(img, v)
        return img


# --------------------------------------------------- native fast path
def _native_resize(lib, arr: np.ndarray, neww: int, newh: int) -> np.ndarray:
    import ctypes
    h, w, c = arr.shape
    out = np.empty((newh, neww, c), np.uint8)
    rc = lib.ip_resize_bicubic_u8(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        newh, neww, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"ip_resize_bicubic_u8 failed ({rc})")
    return out


def _native_pixelbert(lib, img, size: int, longer: int,
                      bucket_hw: Optional[Tuple[int, int]],
                      out_dtype: str = "float32") -> np.ndarray:
    """The C++ resize chain and normalisation, bit for bit the PIL path's
    (``ip_resize_bicubic_u8`` is Pillow's fixed-point bicubic): the
    ``min_max_resize`` and ``fit_bucket`` rules, then the normalisation,
    skipped for ``out_dtype="uint8"`` (normalised on the device)."""
    import ctypes
    arr = np.ascontiguousarray(np.asarray(img.convert("RGB"), np.uint8))
    h, w = arr.shape[:2]
    neww, newh = min_max_size(w, h, size, longer)
    if (newh, neww) != (h, w):
        arr = _native_resize(lib, arr, neww, newh)
        h, w = newh, neww
    if bucket_hw is not None and (w > bucket_hw[1] or h > bucket_hw[0]):
        bh, bw = bucket_hw
        s = min(bw / w, bh / h)
        neww = max(int(w * s) // 32 * 32, 32)
        newh = max(int(h * s) // 32 * 32, 32)
        arr = _native_resize(lib, arr, neww, newh)
        h, w = newh, neww
    if out_dtype == "uint8":
        return arr
    out = np.empty((h, w, 3), np.float32)
    rc = lib.ip_normalize_hwc(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, 3,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"ip_normalize_hwc failed ({rc})")
    return out


# ------------------------------------------------------------- pipelines
def pixelbert_transform(size: int = 800,
                        bucket_hw: Optional[Tuple[int, int]] = None,
                        randaug: bool = False,
                        out_dtype: str = "float32") -> Callable:
    """PIL -> (H, W, 3) float32 in [-1, 1] (reference pixelbert.py:8-30),
    or raw uint8 when out_dtype="uint8" (normalised on the device);
    RandAugment(2, 9) first when ``randaug``.  The C++ resize and
    normalisation where g++ is on PATH (``_native_pixelbert``)."""
    longer = int((1333 / 800) * size)
    ra = RandAugment(2, 9) if randaug else None

    def tr(img) -> np.ndarray:
        from rmcl_tpu_torch.data._native import load_imageproc
        if ra is not None:
            img = ra(img)
        lib = load_imageproc()
        if lib is not None:
            return _native_pixelbert(lib, img, size, longer, bucket_hw, out_dtype)
        img = min_max_resize(img, shorter=size, longer=longer)
        if bucket_hw is not None:
            img = fit_bucket(img, bucket_hw)
        if out_dtype == "uint8":
            return np.ascontiguousarray(
                np.asarray(img.convert("RGB"), np.uint8))
        return to_normalized_array(img)

    return tr


_TRANSFORMS = {
    "pixelbert": lambda size, bucket, dt: pixelbert_transform(
        size, bucket, False, dt),
    "pixelbert_randaug": lambda size, bucket, dt: pixelbert_transform(
        size, bucket, True, dt),
}


def keys_to_transforms(keys: Sequence[str], size: int,
                       bucket_hw: Optional[Tuple[int, int]] = None,
                       out_dtype: str = "float32") -> List[Callable]:
    """Registry (reference vilt/transforms/__init__.py:6-13)."""
    return [_TRANSFORMS[k](size, bucket_hw, out_dtype) for k in keys]
