"""A tile model of the bf16 attention backward kernels
(``rmcl_tpu_torch/csrc/hopper_attention.cuh``), on the CPU, against the JAX
package and the port's plain versions.

The model is written here, not in the package: it walks 64-key tiles with the
online row statistics (``bwd_dq``'s two passes) and 64-query tiles with those
statistics (``bwd_dkv``), sums every product in fp32, and rounds where the
kernels round:
  * kRound (the block halves, ``pallas_block.py:_attn_bwd_math``): ds =
    bf16(p (dp - delta) scale) and pb = bf16(p) before the products;
  * !kRound (the attention core, ``pallas_attention.py:_attn_bwd_kernel``):
    ds and p stay fp32 and enter the tensor cores as the pair hi = bf16(x),
    lo = bf16(x - hi), ``scale`` multiplying the fp32 sums.
Inputs are numpy from a seed, rounded to bf16 values.  The Pallas kernels run
in interpret mode (``RMCL_PALLAS_INTERPRET=1``) in fp32, as
``tests/test_torch_impls.py`` and ``tests/test_torch_ops.py`` run them (this
jaxlib has no bf16 batched dot for their bodies).

Tolerances, each relative to max(1, max|ref|), all below the 2e-2 the card
tests hold the kernels to:
  * !kRound, outputs left in fp32, against flash_masked_attention's VJP:
    1e-4.  The pair carries 16 significant bits (about 2^-17); rounding ds
    and p to bf16 alone (2^-9) misses this tolerance, which the test shows.
  * kRound against pallas_block's dx path in fp32 (no rounding points in
    fp32): 2e-5, the dx tests' fp32 tolerance (summation order).  With the
    bf16 rounding of ds and pb: 4e-3.
  * In bf16 against the port's plain versions (the same rounding points,
    another summation order; outputs rounded to bf16): 8e-3, one bf16 ulp
    (2^-7) of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.ops import pallas_attention as PA
from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu_torch.ops import attention as TA
from rmcl_tpu_torch.ops import fused_block as FB
from tests.test_torch_ops import B, C, EPS, H, S, _attn_args, _inputs
from tests._torch_threads import one_thread  # noqa: F401

TILE = 64
NEG_BIAS = -1e30


def _bf16(x):
    return x.bfloat16().float()


def _pair(x):
    """The value the tensor cores see of an fp32 operand fed as hi + lo."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def tile_model(q, k, v, mask, g, scale, kround, rounding="bf16"):
    """(dq, dk, dv) in fp32, before the outputs' rounding, of the two
    kernels on (B, H, S, D) float32 operands.  ``rounding``: "bf16", the
    kernels' bf16 rounding points; "fp32", none (their fp32 instances);
    "bf16 single": !kRound's ds and p rounded to bf16 alone (not the pair)."""
    Bn, Hn, Sn, _ = q.shape
    bias = torch.where(mask > 0, 0.0, NEG_BIAS)[:, None, None, :]
    rnd = _bf16 if rounding != "fp32" else (lambda x: x)
    feed = {"bf16": _pair, "bf16 single": _bf16, "fp32": lambda x: x}[rounding]
    tiles = [(t0, min(t0 + TILE, Sn)) for t0 in range(0, Sn, TILE)]

    def scores(qt, kt, gt, vt, bt):
        return qt @ kt.transpose(-1, -2) * scale + bt, gt @ vt.transpose(-1, -2)

    # bwd_dq, pass 0: the online row statistics over the key tiles
    m = torch.full((Bn, Hn, Sn, 1), -float("inf"))
    l_run = torch.zeros(Bn, Hn, Sn, 1)
    a_run = torch.zeros(Bn, Hn, Sn, 1)
    for t0, t1 in tiles:
        s, dp = scores(q, k[:, :, t0:t1], g, v[:, :, t0:t1], bias[..., t0:t1])
        mx = torch.maximum(m, s.max(-1, keepdim=True).values)
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l_run = l_run * alpha + p.sum(-1, keepdim=True)
        a_run = a_run * alpha + (p * dp).sum(-1, keepdim=True)
        m = mx
    inv_l, delta = 1.0 / l_run, a_run / l_run
    # pass 1: ds per key tile, dq += ds . k
    dq = torch.zeros_like(q)
    for t0, t1 in tiles:
        kt = k[:, :, t0:t1]
        s, dp = scores(q, kt, g, v[:, :, t0:t1], bias[..., t0:t1])
        x = torch.exp(s - m) * inv_l * (dp - delta)
        dq = dq + (rnd(x * scale) if kround else feed(x)) @ kt
    # bwd_dkv: each key tile walks the query tiles with the statistics
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for t0, t1 in tiles:
        qt, gt = q[:, :, t0:t1], g[:, :, t0:t1]
        st, dpt = scores(k, qt, v, gt, bias.transpose(-1, -2))    # (keys, queries)
        mt, lt, dt = (x[:, :, t0:t1].transpose(-1, -2) for x in (m, inv_l, delta))
        p = torch.exp(st - mt) * lt
        x = p * (dpt - dt)
        if kround:
            dv = dv + rnd(p) @ gt
            dk = dk + rnd(x * scale) @ qt
        else:
            dv = dv + feed(p) @ gt
            dk = dk + feed(x) @ qt
    return (dq, dk, dv) if kround else (dq * scale, dk * scale, dv)


def _model_dqkv(qkv, mask, wproj, g, num_heads, rounding="bf16"):
    """``fused_block._attn_dqkv_plain`` with the tile model as its core:
    dattn = g . Wproj rounded to the operands' type, the kRound kernels,
    outputs rounded to that type."""
    Bn, Sn, C3 = qkv.shape
    Cn, dt = C3 // 3, qkv.dtype
    D = Cn // num_heads
    q, k, v = qkv.reshape(Bn, Sn, 3, num_heads, D).permute(2, 0, 3, 1, 4).float()
    dattn = (g.float() @ wproj.float()).to(dt)
    datt = dattn.reshape(Bn, Sn, num_heads, D).transpose(1, 2).float()
    out = tile_model(q, k, v, mask, datt, D ** -0.5, True, rounding)
    out = [o.to(dt) for o in out]
    return torch.stack(out).permute(1, 3, 0, 2, 4).reshape(Bn, Sn, C3)


def _err(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


def _heads(Bn, Hn, Sn, D, seed, mask_kind="random"):
    """q, k, v, g (B, H, S, D) rounded to bf16 values, and a key mask:
    random; "first_tile" masks every key of the first 64-key tile (a valid
    key comes later); "masked_sample" masks every key of the last sample."""
    r = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(r.randn(Bn, Hn, Sn, D).astype(np.float32)).bfloat16()
                  for _ in range(4))
    mask = (r.rand(Bn, Sn) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if mask_kind == "first_tile":
        mask[:, :TILE], mask[:, -3] = 0, 1
    elif mask_kind == "masked_sample":
        mask[-1] = 0
    return q, k, v, torch.from_numpy(mask), g


@pytest.mark.parametrize("Sn", [37, 130], ids=["S37", "S130"])
def test_model_without_kround_matches_pallas_attention_vjp(Sn, monkeypatch):
    """!kRound with the hi/lo pair, outputs in fp32, against
    flash_masked_attention's VJP (pallas_attention.py:_attn_bwd_kernel):
    within 1e-4.  Rounding ds and p to bf16 alone misses that tolerance."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    q, k, v, mask, g = _heads(2, 3, Sn, 16, Sn)
    q, k, v, g = (t.float() for t in (q, k, v, g))
    scale = 16 ** -0.5
    jargs = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    _, pullback = jax.vjp(
        lambda a, b, c: PA.flash_masked_attention(a, b, c, jnp.asarray(mask.numpy()), scale),
        *jargs)
    ref = pullback(jnp.asarray(g.numpy()))
    ours = tile_model(q, k, v, mask, g, scale, kround=False)
    single = tile_model(q, k, v, mask, g, scale, kround=False, rounding="bf16 single")
    for name, a, b, c in zip(("dq", "dk", "dv"), ours, ref, single):
        assert _err(a, b) <= 1e-4, (name, _err(a, b))
    assert max(_err(a, b) for a, b in zip(single, ref)) > 1e-4


@pytest.mark.parametrize("rounding,tol", [("fp32", 2e-5), ("bf16", 4e-3)])
@pytest.mark.parametrize("residual", [True, False])
def test_model_with_kround_matches_pallas_block_dx(rounding, tol, residual, monkeypatch):
    """kRound as the core of attn_half_dx_plain (the LayerNorm, qkv and proj
    around it as they are) against jax's gradient through pallas_block's dx
    kernel (fused_attn_half_det's VJP) in fp32: the tiles and statistics
    alone within the dx tests' 2e-5; with ds and pb rounded to bf16 within
    4e-3.  S = 37, C = 32, 4 heads, masked tail keys."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    i = {name: a if name == "mask" else torch.from_numpy(a).bfloat16().float().numpy()
         for name, a in _inputs(1).items()}
    g = np.random.RandomState(9).randn(B, S, C).astype(np.float32)
    g = torch.from_numpy(g).bfloat16().float()
    j = {name: jnp.asarray(a) for name, a in i.items()}
    rest = (j["mask"], j["ln_w"], j["ln_b"], j["wqkv"], j["bqkv"], j["wproj"], j["bproj"],
            H, (C // H) ** -0.5, EPS)
    _, vjp = jax.vjp(lambda x: PB.fused_attn_half_det(x, *rest, residual), j["x"])
    ref, = vjp(jnp.asarray(g.numpy()))
    x, mask, lw, lb, wq, bq, wp, _, _, _ = _attn_args(i)
    monkeypatch.setattr(FB, "_attn_dqkv_plain",
                        lambda *a: _model_dqkv(*a, rounding=rounding))
    ours = FB.attn_half_dx_plain(x, mask, lw, lb, wq, bq, wp, g, H, EPS, residual)
    assert _err(ours.numpy(), ref) <= tol, _err(ours.numpy(), ref)


@pytest.mark.parametrize("mask_kind", ["random", "first_tile", "masked_sample"])
@pytest.mark.parametrize("kround", [True, False], ids=["kround", "core"])
def test_model_matches_port_plain_in_bf16(kround, mask_kind):
    """In bf16, at S = 130 (three key tiles, the last ragged), D = 64: the
    model with its rounding points against the port's plain versions,
    _attn_dqkv_plain with Wproj the identity (kRound) and
    masked_attention_bwd_plain (!kRound), within one bf16 ulp (8e-3)."""
    q, k, v, mask, g = _heads(2, 2, 130, 64, 5, mask_kind)
    scale = 64 ** -0.5
    if kround:
        Bn, Hn, Sn, D = q.shape
        qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(Bn, Sn, 3 * Hn * D)
        gb = g.transpose(1, 2).reshape(Bn, Sn, Hn * D)
        eye = torch.eye(Hn * D, dtype=torch.bfloat16)
        ours = _model_dqkv(qkv, mask, eye, gb, Hn)
        ref = FB._attn_dqkv_plain(qkv, mask, eye, gb, Hn)
        assert _err(ours.float(), ref.float()) <= 8e-3
    else:
        ours = tile_model(q.float(), k.float(), v.float(), mask, g.float(), scale, False)
        ref = TA.masked_attention_bwd_plain(q, k, v, mask, g, scale)
        for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
            assert _err(a.bfloat16().float(), b.float()) <= 8e-3, name
