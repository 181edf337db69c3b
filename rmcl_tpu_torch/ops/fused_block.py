"""The two deterministic halves of a ViLT pre-norm block: public ops,
launch counters and plain versions.

Ports of ``rmcl_tpu/ops/pallas_block.py``:
  * ``attn_half`` <- ``fused_attn_half_det`` (``_fwd_impl``/``_half_block_kernel``):
    ``[x +] proj(MHA(qkv(LN1 x)))``
  * ``mlp_half``  <- ``fused_mlp_half`` (``_mlp_fwd_impl``/``_mlp_half_kernel``):
    ``[x +] fc2(gelu_erf(fc1(LN2 x)))``

On a CUDA tensor each op launches the hand-written kernels of
``csrc/block_kernels.cu`` (see the note there for the design) or raises; on
a CPU tensor it runs its plain version.  There is no other switch.

Layouts and types, as the kernels take them: x (B, S, C) in float32 or
bfloat16; weight matrices in torch (out, in) layout and in x's type (cast
them once, not per call); LayerNorm parameters and biases in float32 (the
kernels round biases to x's type, as ``bias.astype(x.dtype)`` does); mask
(B, S) int32, 1 = valid key.

The plain versions follow the Pallas kernels' rounding points: LayerNorm
in fp32 then rounded; every matmul accumulates in fp32 and is rounded to
x's type; + bias, GELU and + residual each round again.
"""

from __future__ import annotations

import torch

from rmcl_tpu_torch.models.layers import layer_norm
from rmcl_tpu_torch.ops import _build
from rmcl_tpu_torch.ops.attention import mha

# kernel launches of each op on CUDA tensors (plain CPU calls do not count)
launches = {"attn_half": 0, "mlp_half": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
def _dense(y, w, b):
    """(y @ w^T) accumulated in fp32, rounded, then + bias rounded."""
    out = (y.float() @ w.to(y.dtype).float().t()).to(y.dtype)
    return out + b.to(y.dtype)


def attn_half_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, eps: float, residual: bool = True):
    """Plain version of ``attn_half`` (``pallas_block.py:_xla_twin`` plus the residual)."""
    B, S, C = x.shape
    D = C // num_heads
    qkv = _dense(layer_norm(x, ln_w, ln_b, eps), wqkv, bqkv)
    qkv = qkv.reshape(B, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    attn = mha(qkv[0], qkv[1], qkv[2], mask, D ** -0.5)
    out = _dense(attn.transpose(1, 2).reshape(B, S, C), wproj, bproj)
    return x + out if residual else out


def mlp_half_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float,
                   residual: bool = True):
    """Plain version of ``mlp_half`` (``pallas_block.py:_mlp_twin`` plus the residual)."""
    h = _dense(layer_norm(x, ln_w, ln_b, eps), w1, b1)
    a = torch.nn.functional.gelu(h.float()).to(x.dtype)
    out = _dense(a, w2, b2)
    return x + out if residual else out


# ------------------------------------------------------------------ checks
def _check(x, named, shapes):
    """Raise on anything the kernels do not take (see the module note)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"fused block ops take CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise RuntimeError("the CUDA block kernels have no backward yet: run "
                           "them under torch.inference_mode() or no_grad()")
    C = x.shape[-1]
    if C % 8:
        raise ValueError(f"hidden size C={C} must be a multiple of 8")
    for name, t in named.items():
        want_dtype = (torch.int32 if name == "mask" else
                      x.dtype if name in ("x", "wqkv", "wproj", "w1", "w2")
                      else torch.float32)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _gemm(lib, x2d, w, bias, out, ln=None, eps=0.0, residual=None, gelu=False):
    M, K = x2d.shape
    N = w.shape[0]
    if M * max(N, K) >= 2 ** 31:
        raise ValueError(f"GEMM of {M}x{N}x{K} exceeds 32-bit indexing")
    ln_w, ln_b = ln if ln is not None else (None, None)
    rc = lib.rmcl_ln_gemm(
        _DTYPE_CODE[x2d.dtype], x2d.data_ptr(),
        ln_w.data_ptr() if ln_w is not None else None,
        ln_b.data_ptr() if ln_b is not None else None, eps,
        w.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), M, N, K, int(gelu),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, "ln_gemm")


# ------------------------------------------------------------------ public
def attn_half(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
              num_heads: int, eps: float, residual: bool = True):
    """``[x +] proj(MHA(qkv(LN1 x)))``.  x: (B, S, C); mask: (B, S)."""
    if x.device.type == "cpu":
        return attn_half_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads, eps, residual)
    B, S, C = x.shape
    if C % num_heads:
        raise ValueError(f"C={C} is not a multiple of num_heads={num_heads}")
    D = C // num_heads
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {_MAX_HEAD_DIM}")
    _check(x, dict(x=x, mask=mask, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, bqkv=bqkv,
                   wproj=wproj, bproj=bproj),
           dict(x=(B, S, C), mask=(B, S), ln_w=(C,), ln_b=(C,),
                wqkv=(3 * C, C), bqkv=(3 * C,), wproj=(C, C), bproj=(C,)))
    lib = _build.library()
    x2d = x.view(B * S, C)
    qkv = torch.empty(B * S, 3 * C, device=x.device, dtype=x.dtype)
    attn = torch.empty(B * S, C, device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    _gemm(lib, x2d, wqkv, bqkv, qkv, ln=(ln_w, ln_b), eps=eps)
    rc = lib.rmcl_masked_attention_fwd(
        _DTYPE_CODE[x.dtype], qkv.data_ptr(), mask.data_ptr(), attn.data_ptr(),
        B, S, num_heads, D, D ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "masked_attention_fwd")
    _gemm(lib, attn, wproj, bproj, out.view(B * S, C),
          residual=x2d if residual else None)
    launches["attn_half"] += 1
    return out


def mlp_half(x, ln_w, ln_b, w1, b1, w2, b2, eps: float, residual: bool = True):
    """``[x +] fc2(gelu_erf(fc1(LN2 x)))``.  x: (B, S, C); w1: (C4, C); w2: (C, C4)."""
    if x.device.type == "cpu":
        return mlp_half_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual)
    B, S, C = x.shape
    C4 = w1.shape[0]
    if C4 % 8:
        raise ValueError(f"MLP hidden size {C4} must be a multiple of 8")
    _check(x, dict(x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2),
           dict(x=(B, S, C), ln_w=(C,), ln_b=(C,), w1=(C4, C), b1=(C4,),
                w2=(C, C4), b2=(C,)))
    lib = _build.library()
    x2d = x.view(B * S, C)
    h = torch.empty(B * S, C4, device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    _gemm(lib, x2d, w1, b1, h, ln=(ln_w, ln_b), eps=eps, gelu=True)
    _gemm(lib, h, w2, b2, out.view(B * S, C),
          residual=x2d if residual else None)
    launches["mlp_half"] += 1
    return out
