"""The two deterministic halves of a ViLT pre-norm block and their dx-only
backwards: public ops, launch counters and plain versions.

Ports of ``rmcl_tpu/ops/pallas_block.py``:
  * ``attn_half`` <- ``fused_attn_half_det`` (``_fwd_impl``/``_half_block_kernel``):
    ``[x +] proj(MHA(qkv(LN1 x)))``
  * ``mlp_half``  <- ``fused_mlp_half`` (``_mlp_fwd_impl``/``_mlp_half_kernel``):
    ``[x +] fc2(gelu_erf(fc1(LN2 x)))``
  * ``attn_half_dx`` <- ``_dx_bwd_impl`` (``_half_block_dx_kernel`` and
    ``_half_block_dx_saved_kernel``, math ``_attn_bwd_math``): dx of
    ``attn_half`` given the output gradient g
  * ``mlp_half_dx``  <- ``_mlp_dx_impl`` (``_mlp_dx_kernel`` and
    ``_mlp_dx_saved_kernel``): dx of ``mlp_half`` given g

On a CUDA tensor each op launches the hand-written kernels of
``csrc/block_kernels.cu`` (see the note there for the design) or raises; on
a CPU tensor it runs its plain version.  There is no other switch.

``attn_half`` and ``mlp_half`` are differentiable with respect to x only
(the deterministic callers, PGD and the saliency pass, differentiate to the
input through frozen weights): when x requires grad they run as
``torch.autograd.Function``s whose backward is ``attn_half_dx`` /
``mlp_half_dx``.  A weight, bias or LayerNorm parameter that requires grad
makes them raise: weight gradients belong to the training kernels.  By
default the forward keeps its qkv (attention) or pre-GELU fc1 output (MLP)
for the backward, which then skips the recompute GEMM
(``save_for_backward=True``, the JAX package's ``save_qkv``/``save_h``);
``save_for_backward=False`` keeps x only and recomputes.

Layouts and types, as the kernels take them: x and g (B, S, C) in float32
or bfloat16; weight matrices in torch (out, in) layout and in x's type (cast
them once, not per call); LayerNorm parameters and biases in float32 (the
kernels round biases to x's type, as ``bias.astype(x.dtype)`` does); mask
(B, S) int32, 1 = valid key.

The plain versions follow the Pallas kernels' rounding points.  Forward:
LayerNorm in fp32 then rounded; every matmul accumulates in fp32 and is
rounded to x's type; + bias, GELU and + residual each round again.
Backward: dattn = g . Wproj rounded; dp fp32; ds = p (dp - sum dp p) scale
from the fp32 p, then rounded; dv from the rounded p; dq, dk, dv rounded;
g . W2 fp32 into the GELU derivative, the product rounded; dy = . Wqkv or
. W1 in fp32, not rounded; LayerNorm backward and + g in fp32, one cast.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from rmcl_tpu_torch.models.layers import layer_norm
from rmcl_tpu_torch.ops import _build
from rmcl_tpu_torch.ops.attention import NEG_BIAS, mha
from rmcl_tpu_torch.ops.philox import keep_threshold

# kernel launches of each op on CUDA tensors (plain CPU calls do not count)
launches = {"attn_half": 0, "mlp_half": 0, "attn_half_dx": 0, "mlp_half_dx": 0,
            # the training ops of ops/fused_block_train.py
            "attn_half_train": 0, "mlp_half_train": 0,
            "attn_half_train_bwd": 0, "mlp_half_train_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_EPI_BIAS, _EPI_DGELU, _EPI_F32 = 0, 1, 2      # ln_gemm epilogues (block_kernels.cu)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
def _dense(y, w, b):
    """(y @ w^T) accumulated in fp32, rounded, then + bias rounded."""
    out = (y.float() @ w.to(y.dtype).float().t()).to(y.dtype)
    return out + b.to(y.dtype)


def _attn_core_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, eps):
    """(proj(MHA(qkv(LN1 x))), qkv (B, S, 3C), attn (B, S, C) before proj)."""
    B, S, C = x.shape
    D = C // num_heads
    qkv = _dense(layer_norm(x, ln_w, ln_b, eps), wqkv, bqkv)
    q, k, v = qkv.reshape(B, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    attn = mha(q, k, v, mask, D ** -0.5).transpose(1, 2).reshape(B, S, C)
    return _dense(attn, wproj, bproj), qkv, attn


def _attn_fwd_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, eps,
                    residual):
    out, qkv, _ = _attn_core_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                   num_heads, eps)
    return (x + out if residual else out), qkv


def attn_half_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, eps: float, residual: bool = True):
    """Plain version of ``attn_half`` (``pallas_block.py:_xla_twin`` plus the residual)."""
    return _attn_fwd_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                           num_heads, eps, residual)[0]


def _mlp_fwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual):
    h = _dense(layer_norm(x, ln_w, ln_b, eps), w1, b1)
    a = torch.nn.functional.gelu(h.float()).to(x.dtype)
    out = _dense(a, w2, b2)
    return (x + out if residual else out), h


def mlp_half_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float,
                   residual: bool = True):
    """Plain version of ``mlp_half`` (``pallas_block.py:_mlp_twin`` plus the residual)."""
    return _mlp_fwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual)[0]


def _ln_parts(x, eps):
    """fp32 (xhat, rstd) of LayerNorm's input."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _ln_bwd_plain(dy, xhat, rstd, ln_w, g, residual, dtype):
    """LayerNorm backward in fp32 from the fp32 dy, + g, one cast."""
    dyh = dy * ln_w
    dx = rstd * (dyh - dyh.mean(-1, keepdim=True)
                 - xhat * (dyh * xhat).mean(-1, keepdim=True))
    if residual:
        dx = dx + g.float()
    return dx.to(dtype)


def _attn_dqkv_plain(qkv, mask, wproj, g, num_heads: int):
    """dqkv (B, S, 3C) of ``proj(MHA(qkv))`` given the output gradient g, step
    by step with the rounding points of ``pallas_block.py:_attn_bwd_math``."""
    B, S, C3 = qkv.shape
    C, H, dt = C3 // 3, num_heads, qkv.dtype
    D = C // H
    scale = D ** -0.5
    q, k, v = qkv.reshape(B, S, 3, H, D).permute(2, 0, 3, 1, 4).float()
    scores = (q @ k.transpose(-1, -2)) * scale
    scores = scores + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_BIAS)
    e = torch.exp(scores - scores.max(-1, keepdim=True).values)
    p = e / e.sum(-1, keepdim=True)                       # (B, H, S, S) fp32
    pb = p.to(dt).float()

    dattn = (g.float() @ wproj.float()).to(dt)            # g . Wproj, rounded
    datt = dattn.reshape(B, S, H, D).transpose(1, 2).float()
    dp = datt @ v.transpose(-1, -2)                       # fp32
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt).float()
    dq = (ds @ k).to(dt)
    dk = (ds.transpose(-1, -2) @ q).to(dt)
    dv = (pb.transpose(-1, -2) @ datt).to(dt)
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, S, 3 * C)


def attn_half_dx_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, g,
                       num_heads: int, eps: float, residual: bool = True,
                       qkv=None):
    """Plain version of ``attn_half_dx``.  ``qkv`` (B, S, 3C) is the forward's
    saved projection; without it LN1 and qkv are recomputed."""
    dt = x.dtype
    xhat, rstd = _ln_parts(x, eps)
    if qkv is None:
        qkv = _dense((xhat * ln_w + ln_b).to(dt), wqkv, bqkv)
    dqkv = _attn_dqkv_plain(qkv, mask, wproj, g, num_heads)
    dy = dqkv.float() @ wqkv.float()                      # fp32, not rounded
    return _ln_bwd_plain(dy, xhat, rstd, ln_w, g, residual, dt)


def _gelu_grad(h32):
    """exact-erf gelu'(h) = Phi(h) + h phi(h), in fp32."""
    cdf = 0.5 * (1.0 + torch.erf(h32 * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * h32 * h32) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + h32 * pdf


def mlp_half_dx_plain(x, ln_w, ln_b, w1, b1, w2, g, eps: float,
                      residual: bool = True, h=None):
    """Plain version of ``mlp_half_dx``, step by step with the rounding
    points of ``pallas_block.py:_mlp_dx_kernel``.  ``h`` (B, S, 4C) is the
    forward's saved pre-GELU fc1 output; without it LN2 and fc1 are
    recomputed."""
    dt = x.dtype
    xhat, rstd = _ln_parts(x, eps)
    if h is None:
        h = _dense((xhat * ln_w + ln_b).to(dt), w1, b1)
    da = g.float() @ w2.float()                           # g . W2, fp32
    dh = (da * _gelu_grad(h.float())).to(dt)
    dy = dh.float() @ w1.float()                          # fp32, not rounded
    return _ln_bwd_plain(dy, xhat, rstd, ln_w, g, residual, dt)


# ------------------------------------------------------------------ checks
_IN_X_TYPE = ("x", "g", "qkv", "attn", "h", "a_d", "wqkv", "wproj", "w1", "w2")


def _check(x, named, shapes):
    """Raise on anything the kernels do not take (see the module note)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"fused block ops take CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    C = x.shape[-1]
    if C % 8:
        raise ValueError(f"hidden size C={C} must be a multiple of 8")
    for name, t in named.items():
        want_dtype = (torch.int32 if name in ("mask", "seeds") else
                      x.dtype if name in _IN_X_TYPE else torch.float32)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_contiguous() or (t.data_ptr() % 16 and name != "seeds"):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _head_dim(C, num_heads):
    if C % num_heads:
        raise ValueError(f"C={C} is not a multiple of num_heads={num_heads}")
    D = C // num_heads
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {_MAX_HEAD_DIM}")
    return D


def _refuse_weight_grads(**params):
    """x is the only input these ops differentiate to."""
    if not torch.is_grad_enabled():
        return
    bad = [k for k, t in params.items() if t.requires_grad]
    if bad:
        raise RuntimeError(
            f"the block ops differentiate with respect to x only, but {bad} "
            "require grad: freeze the parameters (requires_grad_(False)), or "
            "run under torch.no_grad() / inference_mode()")


def _drop_args(drop):
    """ctypes arguments of a kernel's dropout: ``drop`` is None or
    (seeds (B,) int32, rows per sample, draw, p, mask_out or None)."""
    if drop is None:
        return None, 0, 0, 0, 1.0, None
    seeds, rows, draw, p, mask_out = drop
    return (seeds.data_ptr(), rows, draw, keep_threshold(p), 1.0 / (1.0 - p),
            mask_out.data_ptr() if mask_out is not None else None)


def _gemm(lib, a2d, w, bias, out, ln=None, eps=0.0, residual=None, gelu=False,
          aux=None, epi=_EPI_BIAS, w_kn=False, drop=None):
    """out = epi(LN?(a2d) . w^T + bias), or . w when ``w_kn`` (w stored (K, N));
    ``drop``: the epilogue's dropout (``_drop_args``)."""
    M, K = a2d.shape
    N = w.shape[1] if w_kn else w.shape[0]
    if w.shape[0 if w_kn else 1] != K or N % 8 or K % 8:
        raise ValueError(f"GEMM of {tuple(a2d.shape)} against {tuple(w.shape)} "
                         f"(w_kn={w_kn}): sizes must match and be multiples of 8")
    if M * max(N, K) >= 2 ** 31:
        raise ValueError(f"GEMM of {M}x{N}x{K} exceeds 32-bit indexing")
    ln_w, ln_b = ln if ln is not None else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.rmcl_ln_gemm(
        _DTYPE_CODE[a2d.dtype], a2d.data_ptr(), ptr(ln_w), ptr(ln_b), eps,
        w.data_ptr(), ptr(bias), ptr(residual), ptr(aux), out.data_ptr(),
        M, N, K, int(gelu), epi, int(w_kn), *_drop_args(drop),
        torch.cuda.current_stream(a2d.device).cuda_stream)
    _build.check(rc, "ln_gemm")


def _ln_bwd_dx(lib, x2d, dy, ln_w, g2d, eps, residual, ln_b=None, y_out=None,
               stats_out=None):
    """dx of LayerNorm [+ g]; the training backwards also take y = LN(x)
    rounded (``y_out``, needs ``ln_b``) and the rows' (mean, rstd)."""
    dx = torch.empty_like(x2d)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.rmcl_ln_bwd_dx(
        _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), dy.data_ptr(), ln_w.data_ptr(),
        g2d.data_ptr() if residual else None, dx.data_ptr(), x2d.shape[0],
        x2d.shape[1], eps, ptr(ln_b), ptr(y_out), ptr(stats_out),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, "ln_bwd_dx")
    return dx


# ------------------------------------------------------------ forward chains
def _attn_fwd(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, eps,
              residual):
    """(out, qkv (B, S, 3C)): plain on the CPU, the kernels on CUDA."""
    if x.device.type == "cpu":
        return _attn_fwd_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads, eps, residual)
    B, S, C = x.shape
    D = _head_dim(C, num_heads)
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
    return out, qkv.view(B, S, 3 * C)


def _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual, keep_h):
    """(out, h (B, S, C4) or None unless ``keep_h``)."""
    if x.device.type == "cpu":
        return _mlp_fwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual)
    B, S, C = x.shape
    C4 = w1.shape[0]
    _check(x, dict(x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2),
           dict(x=(B, S, C), ln_w=(C,), ln_b=(C,), w1=(C4, C), b1=(C4,),
                w2=(C, C4), b2=(C,)))
    lib = _build.library()
    x2d = x.view(B * S, C)
    a = torch.empty(B * S, C4, device=x.device, dtype=x.dtype)
    h = torch.empty_like(a) if keep_h else None
    out = torch.empty_like(x)
    _gemm(lib, x2d, w1, b1, a, ln=(ln_w, ln_b), eps=eps, gelu=True, aux=h)
    _gemm(lib, a, w2, b2, out.view(B * S, C),
          residual=x2d if residual else None)
    launches["mlp_half"] += 1
    return out, (h.view(B, S, C4) if keep_h else None)


# ----------------------------------------------------------------- dx ops
def attn_half_dx(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, g,
                 num_heads: int, eps: float, residual: bool = True, qkv=None):
    """dx of ``attn_half`` given its output gradient g (B, S, C), ``+ g``
    when ``residual``.  ``qkv`` (B, S, 3C) is the forward's saved projection;
    without it LN1 and the qkv GEMM are recomputed."""
    if x.device.type == "cpu":
        return attn_half_dx_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, g,
                                  num_heads, eps, residual, qkv)
    B, S, C = x.shape
    D = _head_dim(C, num_heads)
    named = dict(x=x, mask=mask, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, bqkv=bqkv,
                 wproj=wproj, g=g)
    shapes = dict(x=(B, S, C), mask=(B, S), ln_w=(C,), ln_b=(C,),
                  wqkv=(3 * C, C), bqkv=(3 * C,), wproj=(C, C), g=(B, S, C),
                  qkv=(B, S, 3 * C))
    if qkv is not None:
        named["qkv"] = qkv
    _check(x, named, shapes)
    lib = _build.library()
    M = B * S
    x2d, g2d = x.view(M, C), g.view(M, C)
    new = lambda *shape, dtype=x.dtype: torch.empty(  # noqa: E731
        *shape, device=x.device, dtype=dtype)
    if qkv is None:
        qkv = new(M, 3 * C)
        _gemm(lib, x2d, wqkv, bqkv, qkv, ln=(ln_w, ln_b), eps=eps)
    dattn, dqkv = new(M, C), new(M, 3 * C)
    stats = new(B, num_heads, S, 3, dtype=torch.float32)
    dy = new(M, C, dtype=torch.float32)
    _gemm(lib, g2d, wproj, None, dattn, w_kn=True)
    rc = lib.rmcl_masked_attention_bwd(
        _DTYPE_CODE[x.dtype], qkv.data_ptr(), mask.data_ptr(), dattn.data_ptr(),
        dqkv.data_ptr(), stats.data_ptr(), B, S, num_heads, D, D ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "masked_attention_bwd")
    _gemm(lib, dqkv, wqkv, None, dy, epi=_EPI_F32, w_kn=True)
    dx = _ln_bwd_dx(lib, x2d, dy, ln_w, g2d, eps, residual)
    launches["attn_half_dx"] += 1
    return dx.view(B, S, C)


def mlp_half_dx(x, ln_w, ln_b, w1, b1, w2, g, eps: float,
                residual: bool = True, h=None):
    """dx of ``mlp_half`` given its output gradient g (B, S, C), ``+ g`` when
    ``residual``.  ``h`` (B, S, C4) is the forward's saved pre-GELU fc1
    output; without it LN2 and the fc1 GEMM are recomputed."""
    if x.device.type == "cpu":
        return mlp_half_dx_plain(x, ln_w, ln_b, w1, b1, w2, g, eps, residual, h)
    B, S, C = x.shape
    C4 = w1.shape[0]
    named = dict(x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, g=g)
    shapes = dict(x=(B, S, C), ln_w=(C,), ln_b=(C,), w1=(C4, C), b1=(C4,),
                  w2=(C, C4), g=(B, S, C), h=(B, S, C4))
    if h is not None:
        named["h"] = h
    _check(x, named, shapes)
    lib = _build.library()
    M = B * S
    x2d, g2d = x.view(M, C), g.view(M, C)
    if h is None:
        h = torch.empty(M, C4, device=x.device, dtype=x.dtype)
        _gemm(lib, x2d, w1, b1, h, ln=(ln_w, ln_b), eps=eps)
    dh = torch.empty(M, C4, device=x.device, dtype=x.dtype)
    dy = torch.empty(M, C, device=x.device, dtype=torch.float32)
    _gemm(lib, g2d, w2, None, dh, aux=h, epi=_EPI_DGELU, w_kn=True)
    _gemm(lib, dh, w1, None, dy, epi=_EPI_F32, w_kn=True)
    dx = _ln_bwd_dx(lib, x2d, dy, ln_w, g2d, eps, residual)
    launches["mlp_half_dx"] += 1
    return dx.view(B, S, C)


# ------------------------------------------------------------------ autograd
class _AttnHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                eps, residual, save):
        out, qkv = _attn_fwd(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                             num_heads, eps, residual)
        ctx.save_for_backward(x, mask, ln_w, ln_b, wqkv, bqkv, wproj,
                              *([qkv] if save else []))
        ctx.conf = (num_heads, eps, residual)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        args = ctx.saved_tensors[:7]
        qkv = ctx.saved_tensors[7] if len(ctx.saved_tensors) > 7 else None
        num_heads, eps, residual = ctx.conf
        dx = attn_half_dx(*args, g.contiguous(), num_heads, eps, residual, qkv)
        return (dx,) + (None,) * 11


class _MlpHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps, residual, save):
        out, h = _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual, keep_h=save)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, *([h] if save else []))
        ctx.conf = (eps, residual)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        args = ctx.saved_tensors[:6]
        h = ctx.saved_tensors[6] if len(ctx.saved_tensors) > 6 else None
        eps, residual = ctx.conf
        dx = mlp_half_dx(*args, g.contiguous(), eps, residual, h)
        return (dx,) + (None,) * 9


# ------------------------------------------------------------------ public
def attn_half(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
              num_heads: int, eps: float, residual: bool = True,
              save_for_backward: bool = True):
    """``[x +] proj(MHA(qkv(LN1 x)))``.  x: (B, S, C); mask: (B, S)."""
    _refuse_weight_grads(ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, bqkv=bqkv,
                         wproj=wproj, bproj=bproj)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AttnHalf.apply(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads, eps, residual, save_for_backward)
    return _attn_fwd(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                     num_heads, eps, residual)[0]


def mlp_half(x, ln_w, ln_b, w1, b1, w2, b2, eps: float, residual: bool = True,
             save_for_backward: bool = True):
    """``[x +] fc2(gelu_erf(fc1(LN2 x)))``.  x: (B, S, C); w1: (C4, C); w2: (C, C4)."""
    _refuse_weight_grads(ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MlpHalf.apply(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual,
                              save_for_backward)
    return _mlp_fwd(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual, keep_h=False)[0]
