"""Build the CUDA sources in ``rmcl_tpu_torch/csrc`` and bind them with ctypes.

The kernels have a plain C interface (no PyTorch headers), so one ``nvcc``
call builds them in seconds.  That happens at first kernel use, never at
import: importing the package needs neither ``nvcc`` nor a card.  The shared
library lands in ``rmcl_tpu_torch/_build/`` under a name keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  ``nvcc`` is taken from ``PATH``, else from
``$CUDA_HOME/bin``, else from the toolkit PyTorch itself found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ST = [ctypes.c_longlong] * 3   # element strides (b, h, s) of a (B, H, S, D) operand
# dropout arguments: seeds, rows per sample, draw, keep threshold, 1/(1-p), mask_out,
# the mask column of column 0
_DROP = [_P, _I, _U, _U, _F, _P, _U]
# entry point -> ctypes argtypes; every pointer and the stream as c_void_p
SIGNATURES = {
    # dtype, a, ln_w, ln_b, eps, ln_scratch (the LayerNorm pass's: fp32 row statistics
    # or the bf16 LayerNorm output), w, bias, residual, aux, out, M, N, K, gelu, epi,
    # w_kn, dropout, stream
    "rmcl_ln_gemm": [_I, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     *_DROP, _P],
    # dtype, x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, stream
    "rmcl_ln_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # -> the widest row rmcl_ln_bwd takes (not an error code)
    "rmcl_ln_bwd_max_width": [],
    # dtype, M, C -> CTAs of rmcl_ln_bwd's training form, which fix its summation order
    "rmcl_ln_bwd_grid": [_I, _I, _I],
    # dtype, g, out, M, N, dropout, stream
    "rmcl_drop_scale": [_I, _P, _P, _I, _I, *_DROP, _P],
    # dtype, M, Na, Nb -> slabs of gemm_tn's split scratch, 1 = none (not an error code)
    "rmcl_gemm_tn_slabs": [_I, _I, _I, _I],
    # dtype, a, b, out, partial (the slabs' scratch or null), M, Na, Nb, stream
    "rmcl_gemm_tn": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    # dtype, a, out, M, N, stream
    "rmcl_colsum": [_I, _P, _P, _I, _I, _P],
    # dtype, qkv, mask, dattn, dqkv, stats, B, S, H, D, scale, stream
    "rmcl_masked_attention_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # dtype, qkv, mask, out, B, S, H, D, scale, stream
    "rmcl_masked_attention_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # dtype, q, k, v, their strides, mask, out, its strides, B, S, H, D, scale, stream
    "rmcl_attention_fwd": [_I, _P, _P, _P, *_ST, _P, _P, *_ST, _I, _I, _I, _I, _F, _P],
    # dtype, q, k, v, their strides, mask, g, its strides, dq, dk, dv, their strides,
    # stats, B, S, H, D, scale, stream
    "rmcl_attention_bwd": [_I, _P, _P, _P, *_ST, _P, _P, *_ST, _P, _P, _P, *_ST, _P,
                           _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in the "
                       "CUDA toolkit PyTorch was built against")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libblock_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rmcl_error_string.argtypes = [ctypes.c_int]
            lib.rmcl_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        msg = library().rmcl_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
