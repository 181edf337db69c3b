"""Native (C++) host input-pipeline kernels, bound with ctypes: the port's own
copy of the JAX package's ``data/_native`` (``wordpiece.cpp``, the WordPiece
batch encoder; ``imageproc.cpp``, the PIL-exact bicubic resize, the
normalisation and the patch-row scatter).  Both give the bytes the Python /
PIL paths give.

``load_wordpiece()`` / ``load_imageproc()`` build their source with ``g++``
at first use into ``rmcl_tpu_torch/_build/``, under a name keyed by a hash
of the source and flags (an edited source is rebuilt, nothing is built next
to the sources), and return the bound library.  Without ``g++`` on ``PATH``
they return None, and the callers (``data/tokenizer.py``,
``data/transforms.py``, ``data/patch_rows.py``) run their Python paths.  A
compile or bind that fails raises, with the compiler's message: nothing
falls back silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "_build"
_lock = threading.Lock()
_libs = {}


def _compile(name: str, opt: str) -> Path:
    """``<name>.cpp`` -> ``_build/_<name>-<hash>.so`` unless already built."""
    src = SRC_DIR / f"{name}.cpp"
    flags = [opt, "-shared", "-fPIC", "-std=c++17"]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"_{name}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.build-{os.getpid()}-{threading.get_ident()}")
        done = subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{done.stderr}")
        os.replace(tmp, so)
    return so


def _load(name: str, opt: str, bind) -> Optional[ctypes.CDLL]:
    with _lock:
        if name not in _libs:
            _libs[name] = (bind(ctypes.CDLL(str(_compile(name, opt))))
                           if shutil.which("g++") else None)
        return _libs[name]


def _bind_wordpiece(lib):
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_vocab_size.restype = ctypes.c_int32
    lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.wp_is_ascii.restype = ctypes.c_int32
    lib.wp_is_ascii.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.wp_encode_batch.restype = ctypes.c_int32
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    return lib


def _bind_imageproc(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ip_resize_bicubic_u8.restype = ctypes.c_int32
    lib.ip_resize_bicubic_u8.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, u8p]
    lib.ip_normalize_hwc.restype = ctypes.c_int32
    lib.ip_normalize_hwc.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p]
    lib.ip_image_to_patch_rows.restype = ctypes.c_int32
    lib.ip_image_to_patch_rows.argtypes = [
        f32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p]
    lib.ip_image_to_patch_rows_u8.restype = ctypes.c_int32
    lib.ip_image_to_patch_rows_u8.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p]
    return lib


def load_wordpiece() -> Optional[ctypes.CDLL]:
    """The WordPiece batch encoder (``wordpiece.cpp``), or None without g++."""
    return _load("wordpiece", "-O2", _bind_wordpiece)


def load_imageproc() -> Optional[ctypes.CDLL]:
    """The PIL-exact bicubic resize, the normalisation and the patch-row
    scatter (``imageproc.cpp``), or None without g++."""
    return _load("imageproc", "-O3", _bind_imageproc)


def image_to_patch_rows(lib, img: np.ndarray, H: int, W: int, P: int,
                        out_rows: np.ndarray) -> None:
    """Scatter one contiguous f32 / u8 (h, w, 3) image into a pre-zeroed
    (gh*gw, P*P*3) patch-row batch element (``imageproc.cpp``)."""
    if img.dtype == np.uint8:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.ip_image_to_patch_rows_u8(
            img.ctypes.data_as(u8p), img.shape[0], img.shape[1],
            H, W, P, out_rows.ctypes.data_as(u8p))
    else:
        f32p = ctypes.POINTER(ctypes.c_float)
        rc = lib.ip_image_to_patch_rows(
            img.ctypes.data_as(f32p), img.shape[0], img.shape[1],
            H, W, P, out_rows.ctypes.data_as(f32p))
    if rc != 0:
        raise RuntimeError(f"ip_image_to_patch_rows failed ({rc})")
