"""The two training halves of a ViLT pre-norm block, dropout inside, and their
full backwards: public ops, plain versions and the autograd functions.

Ports of ``rmcl_tpu/ops/pallas_block.py``:
  * ``attn_half_train`` <- ``fused_attn_half_train`` (``_attn_train_fwd_impl``,
    ``_attn_train_kernel``): ``x + drop_p(proj(MHA(qkv(LN1 x))))``
  * ``attn_half_train_bwd`` <- ``_attn_train_bwd_impl``
    (``_attn_train_bwd_kernel``, math ``_attn_bwd_math``): dx (+ g) and the
    gradients of LN1's weight and bias, Wqkv, bqkv, Wproj and bproj
  * ``mlp_half_train`` <- ``fused_mlp_half_train`` (``_mlp_train_fwd_impl``,
    ``_mlp_train_kernel``): ``x + drop_p(fc2(drop_p(gelu(fc1(LN2 x)))))`` with
    ``tail=True``, ``fc2(drop_p(gelu(fc1(LN2 x))))`` without
  * ``mlp_half_train_bwd`` <- ``_mlp_train_bwd_impl``
    (``_mlp_train_bwd_kernel``): dx (+ g when ``tail``) and the gradients of
    LN2's weight and bias, W1, b1, W2 and b2

On a CUDA tensor each op launches the hand-written kernels of
``csrc/block_kernels.cu`` (see the note there) or raises; on a CPU tensor it
runs its plain version.  Launches are counted in ``fused_block.launches``.

Dropout.  ``seeds`` is (B,) int32, one stream per sample; the keep mask of an
element is a function of (seed, draw, row, column) only
(``ops/philox.py``).  The attention half uses draw 0 for its (S, C) mask; the
MLP half draw 0 for the (S, 4C) mask after GELU and draw 1 for the (S, C) mask
after fc2.  The backward regenerates the masks from the seeds.  At p = 0 the
ops compute ``attn_half`` / ``mlp_half`` and their full gradients; where the
JAX package then runs ``fused_mlp_half`` with its backward, the block runs
``mlp_half_train`` (the same function; ``models/vit.py:Block``).
``emit_mask=True`` makes an op also return the 0/1 masks it applied, for
tests; it is then not differentiable.

Tensor-parallel shards (``models/vit.py:Block`` under a model axis): each op
takes the shard's matrices (qkv (3C/m, C) of whole heads, proj (C, C/m), fc1
(4C/m, C), fc2 (C, 4C/m)) and returns its partial sum of proj or fc2,
dropped with the full (S, C) mask: dropout is linear for a fixed mask, so the
shards' dropped partials add up to the dropped sum.  ``residual=False`` and a
None proj / fc2 bias leave out ``+ x`` and the bias, which the first shard
alone adds; the backward then gives no ``+ g`` and no bias gradient.
``col0`` is the global column of the shard's first hidden column, from which
the in-MLP mask draws (``ops/philox.py``).

What the forward keeps for the backward.  The TPU kernels keep x alone and
recompute, because every intermediate lives in on-chip memory there.  Here the
intermediates pass through device memory anyway, so the forward keeps the
ones the backward reads: qkv (B, S, 3C) and the attention output before proj
(B, S, C); the pre-GELU h and the dropped activation a_d (both (B, S, 4C)).
That saves the backward two GEMMs, the attention core and a mask pass per
block, for 5C + 8C values per token.

Layouts and types as in ``fused_block``: weight matrices in torch (out, in)
layout and x's type.  Every parameter gradient comes back in float32, in the
parameter's layout ((3C, C) for Wqkv).  ``attn_half_train`` and
``mlp_half_train`` take the parameters that receive the gradients (``wqkv``,
...: typically float32 masters) and, optionally, copies already cast to x's
type as the kernels' operands (``wqkv_c``, ...), so that a training step
casts once per optimizer step and not per call.

Rounding points, beyond those of the deterministic ops: the proj / fc2 output
is rounded, biased and rounded as before, then kept and scaled in fp32,
rounded, then + x; GELU stays fp32 into the in-MLP dropout, whose product is
rounded once; gm = keep g / (1 - p) and gf likewise are computed in fp32 and
rounded; the in-MLP mask acts on the fp32 gf . W2 before the GELU derivative;
y = LN(x), attn, a_d and dh enter the weight-gradient products as their rounded
values; all parameter gradients accumulate and stay in fp32.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from rmcl_tpu_torch.ops import _build
from rmcl_tpu_torch.ops.fused_block import (
    _DTYPE_CODE, _EPI_DGELU, _EPI_F32, _attn_core_plain, _attn_fwd, _attn_param_bwd,
    _attn_param_bwd_plain, _check, _colsum, _colsum_plain, _dense, _drop_args, _gelu_grad,
    _dtypes, _gemm, _gemm_tn, _gemm_tn_plain, _head_dim, _like, _ln_backward,
    _ln_backward_plain, _operand, _rows, _stream, launches)
from rmcl_tpu_torch.models.layers import layer_norm
from rmcl_tpu_torch.ops.philox import check_rate, keep_mask


def _drop(v32, keep, p: float, dtype):
    """Inverted dropout of fp32 values: keep ? v / (1 - p) : 0, rounded."""
    return torch.where(keep, v32 * (1.0 / (1.0 - p)), 0.0).to(dtype)


# ------------------------------------------------------------ plain versions
def _attn_train_fwd_plain(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                          num_heads, eps, p, residual=True):
    """(out, qkv, attn, keep)."""
    B, S, C = x.shape
    out, qkv, attn = _attn_core_plain(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                      num_heads, eps)
    keep = keep_mask(seeds, 0, S, C, p)
    out = _drop(out.float(), keep, p, x.dtype)
    return (x + out if residual else out), qkv, attn, keep


def attn_half_train_plain(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                          num_heads: int, eps: float, p: float, residual: bool = True):
    """Plain version of ``attn_half_train``."""
    return _attn_train_fwd_plain(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj,
                                 bproj, num_heads, eps, p, residual)[0]


def attn_half_train_bwd_plain(x, seeds, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn,
                              num_heads: int, eps: float, p: float, residual: bool = True,
                              bias: bool = True):
    """Plain version of ``attn_half_train_bwd``, step by step with the rounding
    points of ``pallas_block.py:_attn_train_bwd_kernel``."""
    B, S, C = x.shape
    gm = _drop(g.float(), keep_mask(seeds, 0, S, C, p), p, x.dtype)
    # dx + the unmasked g
    return _attn_param_bwd_plain(x, mask, ln_w, ln_b, wqkv, wproj, gm, qkv, attn,
                                 num_heads, eps, g if residual else None, bias)


def _mlp_train_fwd_plain(x, seeds, ln_w, ln_b, w1, b1, w2, b2, eps, p, tail,
                         residual=True, col0=0):
    """(out, h, a_d, keep, keep2 or None)."""
    B, S, C = x.shape
    h = _dense(layer_norm(x, ln_w, ln_b, eps), w1, b1)
    keep = keep_mask(seeds, 0, S, w1.shape[0], p, col0)
    a_d = _drop(torch.nn.functional.gelu(h.float()), keep, p, x.dtype)
    out = _dense(a_d, w2, b2)
    keep2 = None
    if tail:
        keep2 = keep_mask(seeds, 1, S, C, p)
        out = _drop(out.float(), keep2, p, x.dtype)
        out = x + out if residual else out
    return out, h, a_d, keep, keep2


def mlp_half_train_plain(x, seeds, ln_w, ln_b, w1, b1, w2, b2, p: float, eps: float,
                         tail: bool = True, residual: bool = True, col0: int = 0):
    """Plain version of ``mlp_half_train``."""
    return _mlp_train_fwd_plain(x, seeds, ln_w, ln_b, w1, b1, w2, b2, eps, p, tail,
                                residual, col0)[0]


def mlp_half_train_bwd_plain(x, seeds, ln_w, ln_b, w1, w2, g, h, a_d, p: float,
                             eps: float, tail: bool = True, residual: bool = True,
                             bias: bool = True, col0: int = 0):
    """Plain version of ``mlp_half_train_bwd``, step by step with the rounding
    points of ``pallas_block.py:_mlp_train_bwd_kernel``."""
    B, S, C = x.shape
    dt = x.dtype
    gf = _drop(g.float(), keep_mask(seeds, 1, S, C, p), p, dt) if tail else g
    keep = keep_mask(seeds, 0, S, w1.shape[0], p, col0)
    da = torch.where(keep, (gf.float() @ w2.float()) * (1.0 / (1.0 - p)), 0.0)
    dh = (da * _gelu_grad(h.float())).to(dt)
    dy = dh.float() @ w1.float()                          # fp32, not rounded
    dx, y, dln_w, dln_b = _ln_backward_plain(_rows(x), _rows(dy), ln_w, ln_b, _rows(g), eps,
                                             tail and residual)
    dh2d, gf2d = _rows(dh), _rows(gf)
    return (dx.view(B, S, C), dln_w, dln_b, _gemm_tn_plain(dh2d, y), _colsum_plain(dh2d),
            _gemm_tn_plain(gf2d, _rows(a_d)), _colsum_plain(gf2d) if bias else None)


# ----------------------------------------------------------- kernel launchers
def _drop_scale(lib, g2d, drop):
    """keep ? round(g / (1 - p)) : 0; ``drop`` as ``fused_block._drop_args`` takes it."""
    out = torch.empty_like(g2d)
    rc = lib.rmcl_drop_scale(
        _DTYPE_CODE[g2d.dtype], g2d.data_ptr(), out.data_ptr(), g2d.shape[0],
        g2d.shape[1], *_drop_args(drop), _stream(g2d))
    _build.check(rc, "drop_scale")
    return out


# ------------------------------------------------------------ forward chains
def _attn_train_fwd(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                    eps, p, emit_mask=False, residual=True):
    """(out, qkv, attn, keep or None): plain on the CPU, the kernels on CUDA."""
    check_rate(p)
    if x.device.type == "cpu":
        return _attn_train_fwd_plain(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj,
                                     bproj, num_heads, eps, p, residual)
    B, S, C = x.shape
    _check(x, dict(seeds=seeds), dict(seeds=(B,)))
    keep = torch.empty_like(x) if emit_mask else None
    out, qkv, attn = _attn_fwd(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                               eps, residual, "attn_half_train", drop=(seeds, S, 0, p, keep))
    return out, qkv, attn, keep


def _mlp_train_fwd(x, seeds, ln_w, ln_b, w1, b1, w2, b2, eps, p, tail, emit_mask=False,
                   residual=True, col0=0):
    """(out, h, a_d, keep or None, keep2 or None)."""
    check_rate(p)
    if x.device.type == "cpu":
        return _mlp_train_fwd_plain(x, seeds, ln_w, ln_b, w1, b1, w2, b2, eps, p, tail,
                                    residual, col0)
    B, S, C = x.shape
    C4 = w1.shape[0]
    _check(x, dict(x=x, seeds=seeds, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2),
           dict(x=(B, S, C), seeds=(B,), ln_w=(C,), ln_b=(C,), w1=(C4, C), b1=(C4,),
                w2=(C, C4), b2=(C,)))
    lib = _build.library()
    x2d = x.view(B * S, C)
    h = torch.empty(B * S, C4, device=x.device, dtype=x.dtype)
    a_d = torch.empty_like(h)
    out = torch.empty_like(x)
    keep = torch.empty_like(h) if emit_mask else None
    keep2 = torch.empty_like(x) if emit_mask and tail else None
    _gemm(lib, x2d, w1, b1, a_d, ln=(ln_w, ln_b), eps=eps, gelu=True, aux=h,
          drop=(seeds, S, 0, p, keep, col0))
    _gemm(lib, a_d, w2, b2, out.view(B * S, C), residual=x2d if tail and residual else None,
          drop=(seeds, S, 1, p, keep2) if tail else None)
    launches["mlp_half_train"] += 1
    return (out, h.view(B, S, C4), a_d.view(B, S, C4),
            keep.view(B, S, C4) if emit_mask else None, keep2)


# ------------------------------------------------------------- backward ops
def attn_half_train_bwd(x, seeds, mask, ln_w, ln_b, wqkv, wproj, g, qkv, attn,
                        num_heads: int, eps: float, p: float, emit_mask: bool = False,
                        residual: bool = True, bias: bool = True):
    """Backward of ``attn_half_train`` given its output gradient g (B, S, C) and
    the forward's ``qkv`` (B, S, 3Ci) and ``attn`` (B, S, Ci), Ci = C but for a
    tensor-parallel shard.  Returns (dx [+ g when ``residual``], dln_w, dln_b,
    dwqkv (3Ci, C), dbqkv, dwproj (C, Ci), dbproj, None unless ``bias``), dx in
    x's type and the rest float32; with ``emit_mask`` also the regenerated mask."""
    check_rate(p)
    B, S, C = x.shape
    if x.device.type == "cpu":
        res = attn_half_train_bwd_plain(x, seeds, mask, ln_w, ln_b, wqkv, wproj, g, qkv,
                                        attn, num_heads, eps, p, residual, bias)
        return res + (keep_mask(seeds, 0, S, C, p),) if emit_mask else res
    Ci = wqkv.shape[0] // 3
    _head_dim(Ci, num_heads)
    _check(x, dict(x=x, seeds=seeds, mask=mask, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv,
                   wproj=wproj, g=g, qkv=qkv, attn=attn),
           dict(x=(B, S, C), seeds=(B,), mask=(B, S), ln_w=(C,), ln_b=(C,),
                wqkv=(3 * Ci, C), wproj=(C, Ci), g=(B, S, C), qkv=(B, S, 3 * Ci),
                attn=(B, S, Ci)))
    keep = torch.empty_like(x).view(B * S, C) if emit_mask else None
    gm = _drop_scale(_build.library(), g.view(B * S, C), (seeds, S, 0, p, keep))
    res = _attn_param_bwd(x, mask, ln_w, ln_b, wqkv, wproj, gm.view(B, S, C), qkv, attn,
                          num_heads, eps, g if residual else None, bias)
    launches["attn_half_train_bwd"] += 1
    return res + (keep.view(B, S, C) > 0,) if emit_mask else res


def mlp_half_train_bwd(x, seeds, ln_w, ln_b, w1, w2, g, h, a_d, p: float, eps: float,
                       tail: bool = True, emit_mask: bool = False, residual: bool = True,
                       bias: bool = True, col0: int = 0):
    """Backward of ``mlp_half_train`` given its output gradient g (B, S, C) and
    the forward's ``h`` and ``a_d`` (B, S, C4), C4 = 4C but for a
    tensor-parallel shard.  Returns (dx [+ g when ``tail`` and ``residual``],
    dln_w, dln_b, dw1 (C4, C), db1, dw2 (C, C4), db2, None unless ``bias``), dx
    in x's type and the rest float32; with ``emit_mask`` also the two
    regenerated masks (the second None unless ``tail``)."""
    check_rate(p)
    B, S, C = x.shape
    C4 = w1.shape[0]
    if x.device.type == "cpu":
        res = mlp_half_train_bwd_plain(x, seeds, ln_w, ln_b, w1, w2, g, h, a_d, p, eps,
                                       tail, residual, bias, col0)
        if emit_mask:
            res += (keep_mask(seeds, 0, S, C4, p, col0),
                    keep_mask(seeds, 1, S, C, p) if tail else None)
        return res
    _check(x, dict(x=x, seeds=seeds, ln_w=ln_w, ln_b=ln_b, w1=w1, w2=w2, g=g, h=h,
                   a_d=a_d),
           dict(x=(B, S, C), seeds=(B,), ln_w=(C,), ln_b=(C,), w1=(C4, C), w2=(C, C4),
                g=(B, S, C), h=(B, S, C4), a_d=(B, S, C4)))
    lib = _build.library()
    M = B * S
    x2d, g2d = x.view(M, C), g.view(M, C)
    keep = torch.empty_like(h).view(M, C4) if emit_mask else None
    keep2 = torch.empty_like(x2d) if emit_mask and tail else None
    gf = _drop_scale(lib, g2d, (seeds, S, 1, p, keep2)) if tail else g2d
    dh = torch.empty(M, C4, device=x.device, dtype=x.dtype)
    dy = torch.empty(M, C, device=x.device, dtype=torch.float32)
    _gemm(lib, gf, w2, None, dh, aux=h, epi=_EPI_DGELU, w_kn=True,
          drop=(seeds, S, 0, p, keep, col0))
    _gemm(lib, dh, w1, None, dy, epi=_EPI_F32, w_kn=True)
    dx, y, dln_w, dln_b = _ln_backward(lib, x2d, dy, ln_w, ln_b, g2d, eps, tail and residual)
    res = (dx.view(B, S, C), dln_w, dln_b,
           _gemm_tn(lib, dh, y), _colsum(lib, dh),
           _gemm_tn(lib, gf, a_d.view(M, C4)), _colsum(lib, gf) if bias else None)
    launches["mlp_half_train_bwd"] += 1
    if emit_mask:
        res += (keep.view(B, S, C4) > 0, keep2.view(B, S, C) > 0 if tail else None)
    return res


# ------------------------------------------------------------------ autograd
class _AttnHalfTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, wqkv_c,
                wproj_c, num_heads, eps, p, residual):
        out, qkv, attn, _ = _attn_train_fwd(x, seeds, mask, ln_w, ln_b, wqkv_c, bqkv,
                                            wproj_c, bproj, num_heads, eps, p,
                                            residual=residual)
        ctx.save_for_backward(x, seeds, mask, ln_w, ln_b, wqkv_c, wproj_c, qkv, attn)
        ctx.conf = (num_heads, eps, p, False, residual, bproj is not None)
        ctx.dtypes = _dtypes(ln_w, ln_b, wqkv, bqkv, wproj, bproj)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, seeds, mask, ln_w, ln_b, wqkv_c, wproj_c, qkv, attn = ctx.saved_tensors
        dx, *dparams = attn_half_train_bwd(x, seeds, mask, ln_w, ln_b, wqkv_c, wproj_c,
                                           g.contiguous(), qkv, attn, *ctx.conf)
        return (dx, None, None, *_like(dparams, ctx.dtypes), None, None, None, None, None,
                None)


class _MlpHalfTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seeds, ln_w, ln_b, w1, b1, w2, b2, w1_c, w2_c, p, eps, tail,
                residual, col0):
        out, h, a_d, _, _ = _mlp_train_fwd(x, seeds, ln_w, ln_b, w1_c, b1, w2_c, b2, eps,
                                           p, tail, residual=residual, col0=col0)
        ctx.save_for_backward(x, seeds, ln_w, ln_b, w1_c, w2_c, h, a_d)
        ctx.conf = (p, eps, tail, False, residual, b2 is not None, col0)
        ctx.dtypes = _dtypes(ln_w, ln_b, w1, b1, w2, b2)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, seeds, ln_w, ln_b, w1_c, w2_c, h, a_d = ctx.saved_tensors
        dx, *dparams = mlp_half_train_bwd(x, seeds, ln_w, ln_b, w1_c, w2_c,
                                          g.contiguous(), h, a_d, *ctx.conf)
        return (dx, None, *_like(dparams, ctx.dtypes), None, None, None, None, None, None,
                None)


# ------------------------------------------------------------------ public
def attn_half_train(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, eps: float, p: float, wqkv_c=None, wproj_c=None,
                    emit_mask: bool = False, residual: bool = True):
    """``x + drop_p(proj(MHA(qkv(LN1 x))))``, differentiable with respect to x
    and all six parameters.  x: (B, S, C); seeds: (B,) int32; mask: (B, S).
    ``wqkv_c`` / ``wproj_c``: the matrices already in x's type (else cast here).
    ``residual=False`` leaves out ``x +``, ``bproj=None`` the bias (a
    tensor-parallel shard but the first)."""
    wqkv_c, wproj_c = _operand(wqkv, wqkv_c, x.dtype), _operand(wproj, wproj_c, x.dtype)
    if emit_mask:
        with torch.no_grad():
            out, _, _, keep = _attn_train_fwd(x, seeds, mask, ln_w, ln_b, wqkv_c, bqkv,
                                              wproj_c, bproj, num_heads, eps, p, True,
                                              residual)
        return out, keep > 0
    if torch.is_grad_enabled():
        return _AttnHalfTrain.apply(x, seeds, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                    wqkv_c, wproj_c, num_heads, eps, p, residual)
    return _attn_train_fwd(x, seeds, mask, ln_w, ln_b, wqkv_c, bqkv, wproj_c, bproj,
                           num_heads, eps, p, residual=residual)[0]


def mlp_half_train(x, seeds, ln_w, ln_b, w1, b1, w2, b2, p: float, eps: float,
                   tail: bool = True, w1_c=None, w2_c=None, emit_mask: bool = False,
                   residual: bool = True, col0: int = 0):
    """``x + drop_p(fc2(drop_p(gelu_erf(fc1(LN2 x)))))`` (``tail``), or
    ``fc2(drop_p(gelu_erf(fc1(LN2 x))))``; differentiable with respect to x and
    all six parameters.  x: (B, S, C); seeds: (B,) int32; w1: (C4, C); w2: (C, C4).
    ``residual=False`` leaves out ``x +``, ``b2=None`` the bias, and the in-MLP
    mask starts at column ``col0`` (a tensor-parallel shard)."""
    w1_c, w2_c = _operand(w1, w1_c, x.dtype), _operand(w2, w2_c, x.dtype)
    if emit_mask:
        with torch.no_grad():
            out, _, _, keep, keep2 = _mlp_train_fwd(x, seeds, ln_w, ln_b, w1_c, b1, w2_c,
                                                    b2, eps, p, tail, True, residual, col0)
        return out, keep > 0, (keep2 > 0 if tail else None)
    if torch.is_grad_enabled():
        return _MlpHalfTrain.apply(x, seeds, ln_w, ln_b, w1, b1, w2, b2, w1_c, w2_c, p,
                                   eps, tail, residual, col0)
    return _mlp_train_fwd(x, seeds, ln_w, ln_b, w1_c, b1, w2_c, b2, eps, p, tail,
                          residual=residual, col0=col0)[0]
