"""The two deterministic halves of a ViLT pre-norm block and their dx-only
backwards, and the attention half with its full backward: public ops, launch
counters and plain versions.

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
  * ``attn_half_full`` <- ``fused_attn_half``: ``proj(MHA(qkv(LN1 x)))``
    (``_fwd_impl`` without the residual), differentiable with respect to x
    and all six parameters; its backward ``attn_half_full_bwd`` <-
    ``_bwd_impl`` (``_half_block_bwd_kernel``, math ``_attn_bwd_math``, and
    the weight products after the kernel): dx, dLN1, dWqkv, dbqkv, dWproj,
    dbproj.  The training blocks run it where the JAX package runs
    ``fused_attn_half`` (``models/vit.py:Block``); like the training ops it
    takes the fp32 masters and cached operands in x's type, and its forward
    keeps qkv and the attention output for the backward.

On a CUDA tensor each op launches the hand-written kernels of
``csrc/block_kernels.cu`` (see the note there for the design) or raises; on
a CPU tensor it runs its plain version.  There is no other switch.

``attn_half`` and ``mlp_half`` are differentiable with respect to x only
(the deterministic callers, PGD and the saliency pass, differentiate to the
input through frozen weights): when x requires grad they run as
``torch.autograd.Function``s whose backward is ``attn_half_dx`` /
``mlp_half_dx``.  A weight, bias or LayerNorm parameter that requires grad
makes them raise: weight gradients belong to ``attn_half_full`` and the
training kernels.  By
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
from rmcl_tpu_torch.ops.attention import _DTYPE_CODE, _MAX_HEAD_DIM, NEG_BIAS, _stream, mha
from rmcl_tpu_torch.ops.philox import keep_mask, keep_threshold

# kernel launches of each op on CUDA tensors (plain CPU calls do not count)
launches = {"attn_half": 0, "mlp_half": 0, "attn_half_dx": 0, "mlp_half_dx": 0,
            "attn_half_full": 0, "attn_half_full_bwd": 0,
            # the training ops of ops/fused_block_train.py
            "attn_half_train": 0, "mlp_half_train": 0,
            "attn_half_train_bwd": 0, "mlp_half_train_bwd": 0,
            # ops/attention.py:masked_attention and ops/dropout.py:dropout
            "masked_attention": 0, "masked_attention_bwd": 0, "dropout": 0}
# launches of the sub-kernels under those ops, in either type: the two GEMMs
# (``_gemm``, ``_gemm_tn``), the attention forward (``_attn_fwd_packed``,
# ``attention._attention_fwd``) and the attention backward pair
# (``_attn_bwd_packed``, ``attention._attention_bwd``), the last two in
# csrc/hopper_attention.cuh (bf16) or csrc/simt_attention.cuh (fp32); the
# LayerNorm backward (``_ln_bwd_dx``, ``_ln_backward``) and the bias-gradient
# column sums (``_colsum``)
sub_launches = {"ln_gemm": 0, "gemm_tn": 0, "attention_fwd": 0, "attention_bwd": 0,
                "ln_bwd": 0, "colsum": 0}
# launches of ln_stats_kernel, the row statistics an fp32 ``_gemm`` with a
# LayerNorm computes before its FMA kernel (csrc/block_kernels.cu); counted
# apart, since they run inside ln_gemm launches counted above
stats_launches = {"ln_stats": 0}

_EPI_BIAS, _EPI_DGELU, _EPI_F32 = 0, 1, 2      # ln_gemm epilogues (block_kernels.cu)


def reset_launches() -> None:
    for counts in (launches, sub_launches, stats_launches):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ plain versions
def _dense(y, w, b):
    """(y @ w^T) accumulated in fp32, rounded, then + bias rounded."""
    out = (y.float() @ w.to(y.dtype).float().t()).to(y.dtype)
    return out + b.to(y.dtype)


def _attn_core_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, eps):
    """(proj(MHA(qkv(LN1 x))), qkv (B, S, 3Ci), attn (B, S, Ci) before proj);
    the attention's inner width Ci is wqkv's rows / 3 (C but for a shard)."""
    B, S, _ = x.shape
    Ci = wqkv.shape[0] // 3
    D = Ci // num_heads
    qkv = _dense(layer_norm(x, ln_w, ln_b, eps), wqkv, bqkv)
    q, k, v = qkv.reshape(B, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    attn = mha(q, k, v, mask, D ** -0.5).transpose(1, 2).reshape(B, S, Ci)
    return _dense(attn, wproj, bproj), qkv, attn


def _attn_fwd_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, eps,
                    residual):
    out, qkv, attn = _attn_core_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                      num_heads, eps)
    return (x + out if residual else out), qkv, attn


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


def _ln_backward_plain(x2d, dy, ln_w, ln_b, g2d, eps, residual):
    """Plain version of ``_ln_backward`` (and, its first output, of
    ``_ln_bwd_dx``): (dx [+ g], y = LN(x) rounded, dln_w, dln_b) of (M, C)
    rows from the fp32 dy, as ``pallas_block.py:_attn_bwd_math`` :305-313
    computes them: LayerNorm and its sums in fp32, dx and y cast once."""
    xhat, rstd = _ln_parts(x2d, eps)
    dx = _ln_bwd_plain(dy, xhat, rstd, ln_w, g2d, residual, x2d.dtype)
    return (dx, (xhat * ln_w + ln_b).to(x2d.dtype), (dy * xhat).sum(0), dy.sum(0))


def _colsum_plain(a2d):
    """Plain version of ``_colsum``: the column sums of (M, N) in fp32."""
    return a2d.float().sum(0)


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
    if qkv is None:
        qkv = _dense(layer_norm(x, ln_w, ln_b, eps), wqkv, bqkv)
    dqkv = _attn_dqkv_plain(qkv, mask, wproj, g, num_heads)
    dy = dqkv.float() @ wqkv.float()                      # fp32, not rounded
    return _ln_backward_plain(_rows(x), _rows(dy), ln_w, ln_b, _rows(g), eps,
                              residual)[0].view(x.shape)


def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _attn_param_bwd_plain(x, mask, ln_w, ln_b, wqkv, wproj, gm, qkv, attn, num_heads,
                          eps, g_res):
    """(dx [+ g_res], dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj) of
    ``proj(MHA(qkv(LN1 x)))`` given its output gradient gm, the forward's qkv
    and attn: ``pallas_block.py:_attn_bwd_math`` step by step, y = LN1 x,
    attn and gm entering the weight-gradient products as their rounded values
    (``_bwd_impl`` :431-441)."""
    dqkv = _attn_dqkv_plain(qkv, mask, wproj, gm, num_heads)
    dy = dqkv.float() @ wqkv.float()                      # fp32, not rounded
    dx, y, dln_w, dln_b = _ln_backward_plain(
        _rows(x), _rows(dy), ln_w, ln_b, None if g_res is None else _rows(g_res), eps,
        g_res is not None)
    dqkv2d, gm2d = _rows(dqkv), _rows(gm)
    return (dx.view(x.shape), dln_w, dln_b, _gemm_tn_plain(dqkv2d, y), _colsum_plain(dqkv2d),
            _gemm_tn_plain(gm2d, _rows(attn)), _colsum_plain(gm2d))


def attn_half_full_bwd_plain(x, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn,
                             num_heads: int, eps: float):
    """Plain version of ``attn_half_full_bwd``."""
    return _attn_param_bwd_plain(x, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn,
                                 num_heads, eps, None)


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
    if h is None:
        h = _dense(layer_norm(x, ln_w, ln_b, eps), w1, b1)
    da = g.float() @ w2.float()                           # g . W2, fp32
    dh = (da * _gelu_grad(h.float())).to(x.dtype)
    dy = dh.float() @ w1.float()                          # fp32, not rounded
    return _ln_backward_plain(_rows(x), _rows(dy), ln_w, ln_b, _rows(g), eps,
                              residual)[0].view(x.shape)


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
    """The ``ln_gemm`` kernel: out = epi(LN?(a2d) . w^T + bias), or . w when
    ``w_kn`` (w stored (K, N), read in place); ``drop``: the epilogue's
    dropout (``_drop_args``).  ``_gemm_plain`` is the same function in torch.
    By type: float32 runs a statistics pass ((mean, rstd) per row into a
    scratch allocated here) when there is a LayerNorm, then a register-tiled
    FMA kernel with a cp.async ring (``csrc/simt_gemm.cuh``: 128 x 128 or
    128 x 64 tiles by its plan, the LayerNorm applied in registers);
    bfloat16 a LayerNorm pass into a scratch allocated here, then a
    persistent TMA + wgmma kernel (``csrc/hopper_gemm.cuh``) whose epilogue
    reads the fp32 accumulators back through shared memory."""
    M, K = a2d.shape
    N = w.shape[1] if w_kn else w.shape[0]
    if w.shape[0 if w_kn else 1] != K or N % 8 or K % 8:
        raise ValueError(f"GEMM of {tuple(a2d.shape)} against {tuple(w.shape)} "
                         f"(w_kn={w_kn}): sizes must match and be multiples of 8")
    if max(M, N) * max(N, K) >= 2 ** 31:
        raise ValueError(f"GEMM of {M}x{N}x{K} exceeds 32-bit indexing")
    ln_w, ln_b = ln if ln is not None else (None, None)
    mask_out = drop[4] if drop is not None else None
    _aligned(*(t for t in (a2d, w, out, bias, residual, aux, ln_w, ln_b, mask_out)
               if t is not None))
    scratch = None   # the LayerNorm pass's: row statistics (fp32), LN(a2d) (bf16)
    if ln is not None:
        scratch = (torch.empty_like(a2d) if a2d.dtype == torch.bfloat16 else
                   torch.empty(M, 2, device=a2d.device, dtype=torch.float32))
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.rmcl_ln_gemm(
        _DTYPE_CODE[a2d.dtype], a2d.data_ptr(), ptr(ln_w), ptr(ln_b), eps, ptr(scratch),
        w.data_ptr(), ptr(bias), ptr(residual), ptr(aux), out.data_ptr(),
        M, N, K, int(gelu), epi, int(w_kn), *_drop_args(drop),
        _stream(a2d))
    _build.check(rc, "ln_gemm")
    sub_launches["ln_gemm"] += 1
    if ln is not None and a2d.dtype == torch.float32:
        stats_launches["ln_stats"] += 1


def _attn_fwd_packed(lib, qkv, mask, attn, num_heads):
    """The attention forward on the packed layout: attn (B, S, C) from qkv
    (B, S, 3C).  bfloat16 runs the wgmma kernel (``csrc/hopper_attention.cuh``:
    head dim a multiple of 8), float32 the FMA one (``csrc/simt_attention.cuh``)."""
    B, S = mask.shape
    D = qkv.shape[-1] // 3 // num_heads
    if qkv.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"head dim {D} must be a multiple of 8 for the bf16 attention forward")
    rc = lib.rmcl_masked_attention_fwd(
        _DTYPE_CODE[qkv.dtype], qkv.data_ptr(), mask.data_ptr(), attn.data_ptr(),
        B, S, num_heads, D, D ** -0.5, _stream(qkv))
    _build.check(rc, "masked_attention_fwd")
    sub_launches["attention_fwd"] += 1


def _attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, num_heads):
    """The attention backward pair (bwd_dq -> bwd_dkv) on the packed layout:
    dqkv (B, S, 3C) from qkv (B, S, 3C) and dattn (B, S, C), with the block
    halves' rounding points; stats (B, H, S, 3) fp32 scratch.  bfloat16 runs
    the wgmma kernels (``csrc/hopper_attention.cuh``: head dim a multiple of
    8), float32 the FMA ones (``csrc/simt_attention.cuh``)."""
    B, S = mask.shape
    D = qkv.shape[-1] // 3 // num_heads
    if qkv.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"head dim {D} must be a multiple of 8 for the bf16 attention backward")
    rc = lib.rmcl_masked_attention_bwd(
        _DTYPE_CODE[qkv.dtype], qkv.data_ptr(), mask.data_ptr(), dattn.data_ptr(),
        dqkv.data_ptr(), stats.data_ptr(), B, S, num_heads, D, D ** -0.5, _stream(qkv))
    _build.check(rc, "masked_attention_bwd")
    sub_launches["attention_bwd"] += 1


def _aligned(*tensors):
    """The GEMM kernels read their operands by 16-byte vectors or TMA."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("GEMM operands must be contiguous and 16-byte aligned")


def _gemm_plain(a2d, w, bias=None, ln=None, eps=0.0, residual=None, gelu=False, aux=None,
                epi=_EPI_BIAS, w_kn=False, drop=None):
    """Plain version of ``_gemm`` with the kernel's rounding points (see
    ``ln_gemm`` in ``csrc/block_kernels.cu``).  ``drop``: None or (seeds,
    rows per sample, draw, p).  Returns (out, the pre-GELU value when
    ``gelu``, else None, the keep mask (M, N) when ``drop``, else None); out
    is fp32 for ``_EPI_F32``, else a2d's type."""
    dt = a2d.dtype
    if ln is not None:
        a2d = layer_norm(a2d, ln[0], ln[1], eps)
    acc = a2d.float() @ (w.float() if w_kn else w.float().t())
    if epi == _EPI_F32:
        return acc, None, None
    keep = None
    if drop is not None:
        seeds, rows, draw, p = drop
        keep = keep_mask(seeds, draw, rows, acc.shape[1], p).reshape(acc.shape)
    scale = lambda v32: torch.where(keep, v32 * (1.0 / (1.0 - drop[3])), 0.0)  # noqa: E731
    if epi == _EPI_DGELU:
        da = acc if keep is None else scale(acc)
        return (da * _gelu_grad(aux.float())).to(dt), None, keep
    v = acc.to(dt)
    if bias is not None:
        v = v + bias.to(dt)
    pre = v if gelu else None
    if gelu:
        a32 = torch.nn.functional.gelu(v.float())
        v = (a32 if keep is None else scale(a32)).to(dt)
    elif keep is not None:
        v = scale(v.float()).to(dt)
    if residual is not None:
        v = v + residual
    return v, pre, keep


def _ln_bwd(lib, x2d, dy, ln_w, ln_b, g2d, dx, y, dln, eps):
    """One launch of the ``ln_bwd`` kernel (``csrc/block_kernels.cu``): dx
    [+ g2d]; with y and dln (then ln_b) its training form.  One warp per row,
    the row in registers, so C (a multiple of 8) is at most
    ``rmcl_ln_bwd_max_width``."""
    M, C = x2d.shape
    if C % 8 or C > lib.rmcl_ln_bwd_max_width():
        raise ValueError(f"LayerNorm backward of width {C}: must be a multiple of 8 "
                         f"and at most {lib.rmcl_ln_bwd_max_width()}")
    _aligned(*(t for t in (x2d, dy, g2d, dx, y) if t is not None))
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.rmcl_ln_bwd(_DTYPE_CODE[x2d.dtype], x2d.data_ptr(), dy.data_ptr(),
                         ln_w.data_ptr(), ptr(ln_b), ptr(g2d), dx.data_ptr(), ptr(y), ptr(dln),
                         M, C, eps, _stream(x2d))
    _build.check(rc, "ln_bwd")
    sub_launches["ln_bwd"] += 1


def _ln_bwd_dx(lib, x2d, dy, ln_w, g2d, eps, residual):
    """dx of LayerNorm [+ g] from the fp32 dy: the ``ln_bwd`` kernel's dx-only
    form (rows 3, 5); ``_ln_backward_plain(...)[0]`` is the same function in
    torch."""
    dx = torch.empty_like(x2d)
    _ln_bwd(lib, x2d, dy, ln_w, None, g2d if residual else None, dx, None, None, eps)
    return dx


def _gemm_tn(lib, a2d, b2d):
    """The ``gemm_tn`` kernel: a^T . b over the rows, fp32, the weight-gradient
    product; ``_gemm_tn_plain`` is the same function in torch.  By type:
    float32 runs the register-tiled FMA kernel of ``csrc/simt_gemm.cuh``
    with both row-major operands copied k-major by cp.async; bfloat16 the
    persistent TMA + wgmma kernel of ``csrc/hopper_gemm.cuh`` with both
    read MN-major.  Where either type's plan finds its output tiles too few
    for the SMs it cuts the rows into fixed slices: ``rmcl_gemm_tn_slabs``
    says how many, the (slabs, Na, Nb) fp32 scratch is allocated here and
    the slabs are added in order, so the result is the same bits on every
    call."""
    (M, Na), (Mb, Nb) = a2d.shape, b2d.shape
    if M != Mb or Na % 8 or Nb % 8 or a2d.dtype != b2d.dtype:
        raise ValueError(f"weight-gradient GEMM of {tuple(a2d.shape)} against "
                         f"{tuple(b2d.shape)}: rows and types must match and "
                         "widths be multiples of 8")
    if M * max(Na, Nb) >= 2 ** 31:
        raise ValueError(f"weight-gradient GEMM of {M}x{Na}x{Nb} exceeds 32-bit indexing")
    _aligned(a2d, b2d)
    code = _DTYPE_CODE[a2d.dtype]
    out = torch.empty(Na, Nb, device=a2d.device, dtype=torch.float32)
    slabs = lib.rmcl_gemm_tn_slabs(code, M, Na, Nb)
    partial = (torch.empty(slabs, Na, Nb, device=a2d.device, dtype=torch.float32)
               if slabs > 1 else None)
    rc = lib.rmcl_gemm_tn(code, a2d.data_ptr(), b2d.data_ptr(), out.data_ptr(),
                          partial.data_ptr() if partial is not None else None, M, Na, Nb,
                          _stream(a2d))
    _build.check(rc, "gemm_tn")
    sub_launches["gemm_tn"] += 1
    return out


def _gemm_tn_plain(a2d, b2d):
    """Plain version of ``_gemm_tn``: a^T . b in fp32."""
    return a2d.float().t() @ b2d.float()


def _colsum(lib, a2d):
    """The ``colsum`` kernel: the column sums of (M, N) in fp32, one launch
    with a fixed summation order (clusters of 8 CTAs along the rows);
    ``_colsum_plain`` is the same function in torch."""
    M, N = a2d.shape
    if N % 8:
        raise ValueError(f"column sums of width {N}: must be a multiple of 8")
    _aligned(a2d)
    out = torch.empty(N, device=a2d.device, dtype=torch.float32)
    rc = lib.rmcl_colsum(_DTYPE_CODE[a2d.dtype], a2d.data_ptr(), out.data_ptr(), M, N,
                         _stream(a2d))
    _build.check(rc, "colsum")
    sub_launches["colsum"] += 1
    return out


def _ln_backward(lib, x2d, dy, ln_w, ln_b, g2d, eps, residual):
    """(dx [+ g], y = LN(x) rounded, dln_w, dln_b) from the fp32 dy: the
    ``ln_bwd`` kernel's training form (rows 9, 7, 2), one launch;
    ``_ln_backward_plain`` is the same function in torch."""
    M, C = x2d.shape
    dx, y = torch.empty_like(x2d), torch.empty_like(x2d)
    dln = torch.empty(2 * C, device=x2d.device, dtype=torch.float32)
    _ln_bwd(lib, x2d, dy, ln_w, ln_b, g2d if residual else None, dx, y, dln, eps)
    return dx, y, dln[:C], dln[C:]


def _attn_param_bwd(x, mask, ln_w, ln_b, wqkv, wproj, gm, qkv, attn, num_heads, eps,
                    g_res):
    """The kernels of ``_attn_param_bwd_plain``: gemm(dattn = gm . Wproj) ->
    masked_attention_bwd_dq / _dkv -> gemm(dy = dqkv . Wqkv, fp32) ->
    ln_bwd [+ g_res] (also y and dLN1, one launch) -> gemm_tn(dWqkv =
    dqkv^T . y) -> colsum(dbqkv) -> gemm_tn(dWproj = gm^T . attn) ->
    colsum(dbproj).  Arguments as checked by the callers."""
    B, S, C = x.shape
    lib = _build.library()
    M = B * S
    x2d, gm2d = x.view(M, C), gm.view(M, C)
    new = lambda *shape, dtype=x.dtype: torch.empty(  # noqa: E731
        *shape, device=x.device, dtype=dtype)
    dattn, dqkv = new(M, C), new(M, 3 * C)
    stats = new(B, num_heads, S, 3, dtype=torch.float32)
    dy = new(M, C, dtype=torch.float32)
    _gemm(lib, gm2d, wproj, None, dattn, w_kn=True)
    _attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, num_heads)
    _gemm(lib, dqkv, wqkv, None, dy, epi=_EPI_F32, w_kn=True)
    dx, y, dln_w, dln_b = _ln_backward(
        lib, x2d, dy, ln_w, ln_b, None if g_res is None else g_res.view(M, C), eps,
        g_res is not None)
    return (dx.view(B, S, C), dln_w, dln_b, _gemm_tn(lib, dqkv, y), _colsum(lib, dqkv),
            _gemm_tn(lib, gm2d, attn.view(M, C)), _colsum(lib, gm2d))


# ------------------------------------------------------------ forward chains
def _attn_fwd(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, eps,
              residual, counter="attn_half", drop=None):
    """(out, qkv (B, S, 3Ci), attn (B, S, Ci)): plain on the CPU, the kernels
    on CUDA, counted under ``counter``; ``drop``: the proj epilogue's dropout
    (``_drop_args``; the training op, which runs its own plain version).  The
    attention's inner width Ci is wqkv's rows / 3: C, or a tensor-parallel
    shard's share of it."""
    if x.device.type == "cpu":
        return _attn_fwd_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                               num_heads, eps, residual)
    B, S, C = x.shape
    Ci = wqkv.shape[0] // 3
    D = _head_dim(Ci, num_heads)
    _check(x, dict(x=x, mask=mask, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, bqkv=bqkv,
                   wproj=wproj, bproj=bproj),
           dict(x=(B, S, C), mask=(B, S), ln_w=(C,), ln_b=(C,),
                wqkv=(3 * Ci, C), bqkv=(3 * Ci,), wproj=(C, Ci), bproj=(C,)))
    lib = _build.library()
    x2d = x.view(B * S, C)
    qkv = torch.empty(B * S, 3 * Ci, device=x.device, dtype=x.dtype)
    attn = torch.empty(B * S, Ci, device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    _gemm(lib, x2d, wqkv, bqkv, qkv, ln=(ln_w, ln_b), eps=eps)
    _attn_fwd_packed(lib, qkv, mask, attn, num_heads)
    _gemm(lib, attn, wproj, bproj, out.view(B * S, C),
          residual=x2d if residual else None, drop=drop)
    launches[counter] += 1
    return out, qkv.view(B, S, 3 * Ci), attn.view(B, S, Ci)


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
    _head_dim(C, num_heads)
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
    _attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, num_heads)
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


def attn_half_full_bwd(x, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn,
                       num_heads: int, eps: float):
    """Backward of ``attn_half_full`` given its output gradient g (B, S, C) and
    the forward's ``qkv`` (B, S, 3C) and ``attn`` (B, S, C).  Returns (dx,
    dln_w, dln_b, dwqkv (3C, C), dbqkv, dwproj (C, C), dbproj), dx in x's type
    and the rest float32."""
    if x.device.type == "cpu":
        return attn_half_full_bwd_plain(x, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn,
                                        num_heads, eps)
    B, S, C = x.shape
    _head_dim(C, num_heads)
    _check(x, dict(x=x, mask=mask, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, wproj=wproj, g=g,
                   qkv=qkv, attn=attn),
           dict(x=(B, S, C), mask=(B, S), ln_w=(C,), ln_b=(C,), wqkv=(3 * C, C),
                wproj=(C, C), g=(B, S, C), qkv=(B, S, 3 * C), attn=(B, S, C)))
    res = _attn_param_bwd(x, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn, num_heads, eps,
                          None)
    launches["attn_half_full_bwd"] += 1
    return res


# ------------------------------------------------------------------ autograd
def _like(grads, dtypes):
    """Parameter gradients in their parameters' types (float32 masters: as is)."""
    return tuple(g.to(dt) for g, dt in zip(grads, dtypes))


def _operand(w, w_c, dtype):
    return w.detach().to(dtype).contiguous() if w_c is None else w_c


class _AttnHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                eps, residual, save):
        out, qkv, _ = _attn_fwd(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
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


class _AttnHalfFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, wqkv_c, wproj_c,
                num_heads, eps):
        out, qkv, attn = _attn_fwd(x, mask, ln_w, ln_b, wqkv_c, bqkv, wproj_c, bproj,
                                   num_heads, eps, False, "attn_half_full")
        ctx.save_for_backward(x, mask, ln_w, ln_b, wqkv_c, wproj_c, qkv, attn)
        ctx.conf = (num_heads, eps)
        ctx.dtypes = tuple(t.dtype for t in (ln_w, ln_b, wqkv, bqkv, wproj, bproj))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mask, ln_w, ln_b, wqkv_c, wproj_c, qkv, attn = ctx.saved_tensors
        dx, *dparams = attn_half_full_bwd(x, mask, ln_w, ln_b, wqkv_c, wproj_c,
                                          g.contiguous(), qkv, attn, *ctx.conf)
        return (dx, None, *_like(dparams, ctx.dtypes), None, None, None, None)


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


def attn_half_full(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                   eps: float, wqkv_c=None, wproj_c=None):
    """``proj(MHA(qkv(LN1 x)))`` with no residual (``fused_attn_half``),
    differentiable with respect to x and all six parameters: the training
    attention half of the block whose dropout and residual run outside.
    ``wqkv_c`` / ``wproj_c``: the matrices already in x's type (else cast
    here); every parameter gradient comes back in its parameter's type."""
    wqkv_c, wproj_c = _operand(wqkv, wqkv_c, x.dtype), _operand(wproj, wproj_c, x.dtype)
    if torch.is_grad_enabled():
        return _AttnHalfFull.apply(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, wqkv_c,
                                   wproj_c, num_heads, eps)
    return _attn_fwd(x, mask, ln_w, ln_b, wqkv_c, bqkv, wproj_c, bproj, num_heads, eps,
                     False, "attn_half_full")[0]
