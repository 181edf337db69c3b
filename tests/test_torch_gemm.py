"""The two GEMM sub-kernels of the block ops, ``ln_gemm`` and ``gemm_tn``
(rmcl_tpu_torch/csrc/block_kernels.cu on hopper_gemm.cuh), through their
plain versions ``fused_block._gemm_plain`` / ``_gemm_tn_plain``: chained as
the ops chain the kernels, they give the op-level plain versions, which
tests/test_torch_ops.py and test_torch_train.py hold against the JAX
package.  One case per chain, so every mode of the sub-kernels is covered:
the LayerNorm operand, bias, GELU keeping the pre-GELU value, dropout
(draws 0 and 1, masks from philox.keep_mask), residual, the (K, N) weight
layout, the GELU derivative with and without dropout, the fp32 output, and
the weight-gradient product.  On the CPU; the kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.ops import fused_block_train as FT
from rmcl_tpu_torch.ops.attention import mha
from rmcl_tpu_torch.ops.philox import keep_mask
from tests._torch_threads import one_thread  # noqa: F401

B, S, C, H = 2, 37, 32, 4
EPS = 1e-6
P = 0.1
M = B * S
# Relative to max(1, max|ref|).  The chains do the op-level plain versions'
# arithmetic step for step; only the matrix products run on 2-D rather than
# 3-D operands, which may block their sums otherwise: fp32 agrees to
# summation order, and bf16 may round such a tie one way or the other.
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


def _inputs(dtype, seed=0):
    r = np.random.RandomState(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dt)
    w = lambda *s: t(0.1 * r.randn(*s), dtype)  # noqa: E731
    mask = (r.rand(B, S) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return dict(
        x=t(r.randn(B, S, C), dtype), g=t(r.randn(B, S, C), dtype),
        mask=torch.from_numpy(mask), ln=(t(1.0 + 0.1 * r.randn(C)), t(0.1 * r.randn(C))),
        wqkv=w(3 * C, C), bqkv=t(0.1 * r.randn(3 * C)), wproj=w(C, C),
        bproj=t(0.1 * r.randn(C)), w1=w(4 * C, C), b1=t(0.1 * r.randn(4 * C)),
        w2=w(C, 4 * C), b2=t(0.1 * r.randn(C)),
        seeds=torch.from_numpy(r.randint(-2 ** 31, 2 ** 31, B).astype(np.int32)))


def _close(ours, ref, dtype, what):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, what
    ours, ref = ours.float(), ref.float()
    err = (ours - ref).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, ref.abs().max().item()), (what, err)


def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _heads_attention(qkv2d, mask):
    """MHA of a (M, 3C) projection as the block does it, back to (M, C)."""
    q, k, v = qkv2d.reshape(B, S, 3, H, C // H).permute(2, 0, 3, 1, 4)
    return mha(q, k, v, mask, (C // H) ** -0.5).transpose(1, 2).reshape(M, C)


def chain_attn_half(d, dtype):
    """qkv = ln_gemm(LN1, bias), the attention core, ln_gemm(proj, bias, + x)."""
    x2d = _rows(d["x"])
    qkv, pre, keep = FB._gemm_plain(x2d, d["wqkv"], d["bqkv"], ln=d["ln"], eps=EPS)
    assert pre is None and keep is None
    out, _, _ = FB._gemm_plain(_heads_attention(qkv, d["mask"]), d["wproj"], d["bproj"],
                               residual=x2d)
    ref = FB.attn_half_plain(d["x"], d["mask"], *d["ln"], d["wqkv"], d["bqkv"], d["wproj"],
                             d["bproj"], H, EPS)
    return [(out, _rows(ref), "out")]


def chain_mlp_half(d, dtype):
    """a = ln_gemm(LN2, bias, GELU, pre-GELU kept), ln_gemm(fc2, bias, + x)."""
    x2d = _rows(d["x"])
    a, h, _ = FB._gemm_plain(x2d, d["w1"], d["b1"], ln=d["ln"], eps=EPS, gelu=True)
    out, _, _ = FB._gemm_plain(a, d["w2"], d["b2"], residual=x2d)
    ref, ref_h = FB._mlp_fwd_plain(d["x"], *d["ln"], d["w1"], d["b1"], d["w2"], d["b2"],
                                   EPS, True)
    return [(out, _rows(ref), "out"), (h, _rows(ref_h), "h")]


def chain_attn_half_dx(d, dtype):
    """dattn = g . Wproj ((K, N) layout), the attention backward, dy = dqkv .
    Wqkv in fp32, the LayerNorm backward."""
    x2d, g2d = _rows(d["x"]), _rows(d["g"])
    qkv = _rows(FB._attn_fwd_plain(d["x"], d["mask"], *d["ln"], d["wqkv"], d["bqkv"],
                                   d["wproj"], d["bproj"], H, EPS, True)[1])
    dattn, _, _ = FB._gemm_plain(g2d, d["wproj"], w_kn=True)
    dqkv = _rows(FB._attn_dqkv_plain(qkv.view(B, S, 3 * C), d["mask"], d["wproj"], d["g"], H))
    dy, _, _ = FB._gemm_plain(dqkv, d["wqkv"], epi=FB._EPI_F32, w_kn=True)
    xhat, rstd = FB._ln_parts(x2d, EPS)
    dx = FB._ln_bwd_plain(dy, xhat, rstd, d["ln"][0], g2d, True, dtype)
    ref = FB.attn_half_dx_plain(d["x"], d["mask"], *d["ln"], d["wqkv"], d["bqkv"],
                                d["wproj"], d["g"], H, EPS, True, qkv.view(B, S, 3 * C))
    return [(dattn, (g2d.float() @ d["wproj"].float()).to(dtype), "dattn"),
            (dx, _rows(ref), "dx")]


def chain_mlp_half_dx(d, dtype):
    """dh = ln_gemm(g . W2, gelu'(h)), dy = dh . W1 in fp32, LayerNorm backward."""
    x2d, g2d = _rows(d["x"]), _rows(d["g"])
    _, h, _ = FB._gemm_plain(x2d, d["w1"], d["b1"], ln=d["ln"], eps=EPS, gelu=True)
    dh, _, _ = FB._gemm_plain(g2d, d["w2"], aux=h, epi=FB._EPI_DGELU, w_kn=True)
    dy, _, _ = FB._gemm_plain(dh, d["w1"], epi=FB._EPI_F32, w_kn=True)
    xhat, rstd = FB._ln_parts(x2d, EPS)
    dx = FB._ln_bwd_plain(dy, xhat, rstd, d["ln"][0], g2d, True, dtype)
    ref = FB.mlp_half_dx_plain(d["x"], *d["ln"], d["w1"], d["b1"], d["w2"], d["g"], EPS,
                               True, h.view(B, S, 4 * C))
    return [(dx, _rows(ref), "dx")]


def chain_attn_half_train(d, dtype):
    """The proj epilogue with dropout (draw 0) before + x."""
    x2d = _rows(d["x"])
    ref, qkv, attn, keep = FT._attn_train_fwd_plain(
        d["x"], d["seeds"], d["mask"], *d["ln"], d["wqkv"], d["bqkv"], d["wproj"],
        d["bproj"], H, EPS, P)
    out, _, m = FB._gemm_plain(_rows(attn), d["wproj"], d["bproj"], residual=x2d,
                               drop=(d["seeds"], S, 0, P))
    assert torch.equal(m, _rows(keep))
    return [(out, _rows(ref), "out")]


def chain_mlp_half_train(d, dtype):
    """fc1 with LayerNorm, GELU, the pre-GELU value and dropout (draw 0); fc2
    with dropout (draw 1) and + x."""
    x2d = _rows(d["x"])
    a_d, h, m1 = FB._gemm_plain(x2d, d["w1"], d["b1"], ln=d["ln"], eps=EPS, gelu=True,
                                drop=(d["seeds"], S, 0, P))
    out, _, m2 = FB._gemm_plain(a_d, d["w2"], d["b2"], residual=x2d,
                                drop=(d["seeds"], S, 1, P))
    ref, ref_h, ref_a, keep, keep2 = FT._mlp_train_fwd_plain(
        d["x"], d["seeds"], *d["ln"], d["w1"], d["b1"], d["w2"], d["b2"], EPS, P, True)
    assert torch.equal(m1, _rows(keep)) and torch.equal(m2, _rows(keep2))
    return [(out, _rows(ref), "out"), (h, _rows(ref_h), "h"), (a_d, _rows(ref_a), "a_d")]


def chain_attn_half_train_bwd(d, dtype):
    """The weight gradients dWqkv = dqkv^T . y and dWproj = gm^T . attn."""
    seeds, x2d = d["seeds"], _rows(d["x"])
    _, qkv, attn, keep = FT._attn_train_fwd_plain(
        d["x"], seeds, d["mask"], *d["ln"], d["wqkv"], d["bqkv"], d["wproj"], d["bproj"],
        H, EPS, P)
    gm = torch.where(keep, d["g"].float() * (1.0 / (1.0 - P)), 0.0).to(dtype)
    dqkv = _rows(FB._attn_dqkv_plain(qkv, d["mask"], d["wproj"], gm, H))
    xhat, _ = FB._ln_parts(x2d, EPS)
    y = (xhat * d["ln"][0] + d["ln"][1]).to(dtype)
    ref = FT.attn_half_train_bwd_plain(d["x"], seeds, d["mask"], *d["ln"], d["wqkv"],
                                       d["wproj"], d["g"], qkv, attn, H, EPS, P)
    return [(FB._gemm_tn_plain(dqkv, y), ref[3], "dwqkv"),
            (FB._gemm_tn_plain(_rows(gm), _rows(attn)), ref[5], "dwproj")]


def chain_mlp_half_train_bwd(d, dtype):
    """dh = ln_gemm(gf . W2, dropout (draw 0), gelu'(h)), dy = dh . W1 fp32,
    dW1 = dh^T . y, dW2 = gf^T . a_d."""
    seeds, x2d, g2d = d["seeds"], _rows(d["x"]), _rows(d["g"])
    _, h, a_d, _, keep2 = FT._mlp_train_fwd_plain(
        d["x"], seeds, *d["ln"], d["w1"], d["b1"], d["w2"], d["b2"], EPS, P, True)
    gf = torch.where(_rows(keep2), g2d.float() * (1.0 / (1.0 - P)), 0.0).to(dtype)
    dh, _, m = FB._gemm_plain(gf, d["w2"], aux=_rows(h), epi=FB._EPI_DGELU, w_kn=True,
                              drop=(seeds, S, 0, P))
    assert torch.equal(m, _rows(keep_mask(seeds, 0, S, 4 * C, P)))
    dy, _, _ = FB._gemm_plain(dh, d["w1"], epi=FB._EPI_F32, w_kn=True)
    xhat, rstd = FB._ln_parts(x2d, EPS)
    y = (xhat * d["ln"][0] + d["ln"][1]).to(dtype)
    dx = FB._ln_bwd_plain(dy, xhat, rstd, d["ln"][0], g2d, True, dtype)
    ref = FT.mlp_half_train_bwd_plain(d["x"], seeds, *d["ln"], d["w1"], d["w2"], d["g"], h,
                                      a_d, P, EPS, True)
    return [(dx, _rows(ref[0]), "dx"), (FB._gemm_tn_plain(dh, y), ref[3], "dw1"),
            (FB._gemm_tn_plain(gf, _rows(a_d)), ref[5], "dw2")]


CHAINS = [chain_attn_half, chain_mlp_half, chain_attn_half_dx, chain_mlp_half_dx,
          chain_attn_half_train, chain_mlp_half_train, chain_attn_half_train_bwd,
          chain_mlp_half_train_bwd]


@pytest.mark.parametrize("chain", CHAINS, ids=lambda f: f.__name__[len("chain_"):])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_sub_kernels_compose_to_the_ops(chain, dtype):
    with torch.no_grad():
        for ours, ref, what in chain(_inputs(dtype), dtype):
            _close(ours, ref, dtype, what)


def test_gemm_plain_modes():
    """Each epilogue of ``_gemm_plain`` against its definition written out."""
    d = _inputs(torch.float32, seed=1)
    a, w, bias, res = _rows(d["x"]), d["w1"], d["b1"], torch.randn(M, 4 * C)
    acc = a @ w.t()
    out, pre, keep = FB._gemm_plain(a, w, bias)
    assert torch.equal(out, acc + bias) and pre is None and keep is None
    out, _, _ = FB._gemm_plain(a, w.t().contiguous(), epi=FB._EPI_F32, w_kn=True)
    torch.testing.assert_close(out, acc, rtol=0, atol=1e-6)
    out, pre, keep = FB._gemm_plain(a, w, bias, gelu=True, residual=res,
                                    drop=(d["seeds"], S, 0, 0.5))
    assert torch.equal(pre, acc + bias)
    assert torch.equal(keep, _rows(keep_mask(d["seeds"], 0, S, 4 * C, 0.5)))
    want = torch.where(keep, torch.nn.functional.gelu(acc + bias) * 2.0, 0.0) + res
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    h = torch.randn(M, 4 * C)
    out, _, _ = FB._gemm_plain(a, w, aux=h, epi=FB._EPI_DGELU)
    torch.testing.assert_close(out, acc * FB._gelu_grad(h), rtol=0, atol=1e-6)
    torch.testing.assert_close(FB._gemm_tn_plain(a, res), a.t() @ res, rtol=0, atol=1e-5)


def _row_slices(M, slices, bk=16):
    """The row ranges of gemm_tn's split contraction as the kernels cut it:
    slabs of ``bk`` rows, ceil(slabs / slices) of them to a slice, the last
    slice ragged."""
    nkb = -(-M // bk)
    kps = -(-nkb // slices)
    return [(z * kps * bk, min(M, (z + 1) * kps * bk)) for z in range(-(-nkb // kps))]


# 7: the slices the fp32 plan (csrc/simt_gemm.cuh:sg::plan) takes for dWproj
# (768 x 768 over 3,856 rows) on a 132-SM H100; 8: the most it takes
@pytest.mark.parametrize("slices", [1, 2, 7, 8])
@pytest.mark.parametrize("M", [111, 482, 3856], ids=lambda m: f"M{m}")
def test_gemm_tn_row_slices_add_to_the_product(M, slices):
    """The split-M contract of gemm_tn (fp32 and bf16): each fixed slice of
    rows gives its own product, the slices are added in order, and the sum
    is the unsliced a^T . b up to summation order (1e-6 of max(1, max|ref|))."""
    r = np.random.RandomState(M + slices)
    a = torch.from_numpy(r.randn(M, 48).astype(np.float32))
    b = torch.from_numpy(r.randn(M, 40).astype(np.float32))
    cuts = _row_slices(M, slices)
    assert cuts[0][0] == 0 and cuts[-1][1] == M and len(cuts) <= slices
    assert all(hi > lo and hi == nlo for (lo, hi), (nlo, _) in zip(cuts, cuts[1:]))
    total = FB._gemm_tn_plain(a[cuts[0][0]:cuts[0][1]], b[cuts[0][0]:cuts[0][1]])
    for lo, hi in cuts[1:]:
        total = total + FB._gemm_tn_plain(a[lo:hi], b[lo:hi])
    ref = FB._gemm_tn_plain(a, b)
    err = (total - ref).abs().max().item()
    assert err <= 1e-6 * max(1.0, ref.abs().max().item()), err
