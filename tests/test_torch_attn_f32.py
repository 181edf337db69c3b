"""A tile model of the fp32 attention kernels
(``rmcl_tpu_torch/csrc/simt_attention.cuh``: ``fwd_kernel``, ``bwd_dq_kernel``
and ``bwd_dkv_kernel``), on the CPU, against the JAX package and the port's
plain versions.

The model is written here, not in the package.  Every score is one fmaf
chain over d = 0 ... D - 1 from 0, as the kernels sum it (each fma modelled
by the fp64 sum of the exact fp64 product, rounded to fp32), then
fmaf(acc, scale, key bias).  The forward walks key tiles of ``FWD_TILE``
with the online row max m and sum l of e = exp(s - m), rescales the output
rows by exp(m_old - m_new), adds E . V and divides by l at the end.  The
backward walks the key tiles twice for each query row (``bwd_dq``: m, l and
sum e dp online, delta = that sum / l; then p = exp(s - m) (1 / l), ds = p
(dp - delta), dq += ds . k) and the query tiles of ``BWD_TILE`` for each key
(``bwd_dkv``: s^T from K . Q^T, p and ds from the statistics, dv += p^T . g,
dk += ds^T . q).  kRound (the block halves) scales ds; !kRound (the
attention core) scales the sums dq and dk: in fp32 the only difference.
Inputs are numpy from a seed.  The Pallas kernels run in interpret mode
(``RMCL_PALLAS_INTERPRET=1``), as ``tests/test_torch_ops.py`` runs them.

Tolerances, each relative to max(1, max|ref|), fp32 throughout, so that only
the order of the sums differs (the card tests hold the kernels to their
plain versions within 2e-4):
  * against flash_masked_attention's forward and VJP
    (``pallas_attention.py:_attn_kernel``, ``_attn_bwd_kernel``) and against
    pallas_block's dx path (``_attn_bwd_math`` through ``fused_attn_half_det``'s
    VJP), the LayerNorm, qkv and proj around the model as they are: 2e-5, the
    dx tests' fp32 tolerance;
  * against the port's plain ``mha``, ``masked_attention_bwd_plain`` and
    ``_attn_dqkv_plain``: 2e-5.
The two backward walks compute each ds on their own (``bwd_dq`` with its
online statistics, ``bwd_dkv`` from the stats scratch), so both must sum
every score and every dp in the same order to agree bit for bit.  A probe
reads ds from each: n columns of q and of k made one-hot, dq and dk then
hold ds at n x n (query, key) pairs, each an exact sum of one product and
zeros (``tests/test_torch_cuda.py:one_hot_probe``).  That file and
``chip_smoke.py`` hold the card's kernels to it; here it is checked on the model and the plain version, and
shown to catch a walk that sums d in another order.
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
from tests.test_torch_cuda import one_hot_probe, probe_ds
from tests.test_torch_ops import B, C, EPS, H, S, _attn_args, _inputs
from tests._torch_threads import one_thread  # noqa: F401

FWD_TILE = 32     # fwd_kernel's key tile (8 x its columns a thread)
BWD_TILE = 32     # bwd_dq_kernel's key tile and bwd_dkv_kernel's query tile
NEG_BIAS = -1e30
TOL = 2e-5


def _dots(a, b):
    """(..., Ra, D) x (..., Rb, D) -> (..., Ra, Rb), each element one fmaf
    chain over d in order from 0."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float64)
    a64, b64 = a.double(), b.double()
    for d in range(a.shape[-1]):
        acc = (acc + a64[..., :, None, d] * b64[..., None, :, d]).float().double()
    return acc.float()


def _fma(x, scale, bias):
    return (x.double() * scale + bias.double()).float()


def _bias(mask):
    return torch.where(mask > 0, 0.0, NEG_BIAS)[:, None, None, :]      # (B, 1, 1, S)


def fwd_model(q, k, v, mask, scale, tile=FWD_TILE):
    """(the output, the scores of every key tile (B, H, S, S)) of fwd_kernel
    on (B, H, S, D) float32 operands."""
    Bn, Hn, Sn, D = q.shape
    bias = _bias(mask)
    m = torch.full((Bn, Hn, Sn, 1), -float("inf"))
    l_run = torch.zeros(Bn, Hn, Sn, 1)
    o = torch.zeros(Bn, Hn, Sn, D)
    scores = []
    for t0 in range(0, Sn, tile):
        t1 = min(t0 + tile, Sn)
        s = _fma(_dots(q, k[:, :, t0:t1]), scale, bias[..., t0:t1])
        scores.append(s)
        mx = torch.maximum(m, s.max(-1, keepdim=True).values)
        alpha = torch.exp(m - mx)
        e = torch.exp(s - mx)
        l_run = l_run * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + e @ v[:, :, t0:t1]
        m = mx
    return o / l_run, torch.cat(scores, -1)


def bwd_model(q, k, v, mask, g, scale, kround, tile=BWD_TILE, kv_dots=_dots):
    """((dq, dk, dv), bwd_dq's scores, bwd_dkv's scores transposed) of the
    backward pair on (B, H, S, D) float32 operands; kv_dots: bwd_dkv's dot
    products."""
    Bn, Hn, Sn, _ = q.shape
    bias = _bias(mask)
    tiles = [(t0, min(t0 + tile, Sn)) for t0 in range(0, Sn, tile)]
    m = torch.full((Bn, Hn, Sn, 1), -float("inf"))
    l_run = torch.zeros(Bn, Hn, Sn, 1)
    a_run = torch.zeros(Bn, Hn, Sn, 1)
    for t0, t1 in tiles:                    # bwd_dq, pass 0
        s = _fma(_dots(q, k[:, :, t0:t1]), scale, bias[..., t0:t1])
        dp = _dots(g, v[:, :, t0:t1])
        mx = torch.maximum(m, s.max(-1, keepdim=True).values)
        alpha = torch.exp(m - mx)
        e = torch.exp(s - mx)
        l_run = l_run * alpha + e.sum(-1, keepdim=True)
        a_run = a_run * alpha + (e * dp).sum(-1, keepdim=True)
        m = mx
    delta = a_run / l_run
    dq, dq_scores = torch.zeros_like(q), []
    for t0, t1 in tiles:                    # pass 1
        kt = k[:, :, t0:t1]
        s = _fma(_dots(q, kt), scale, bias[..., t0:t1])
        dq_scores.append(s)
        ds = torch.exp(s - m) * (1.0 / l_run) * (_dots(g, v[:, :, t0:t1]) - delta)
        dq = dq + (ds * scale if kround else ds) @ kt
    dk, dv, kv_scores = torch.zeros_like(k), torch.zeros_like(v), []
    kb = bias.transpose(-1, -2)             # (B, 1, S keys, 1)
    for t0, t1 in tiles:                    # bwd_dkv: the query tiles
        qt, gt = q[:, :, t0:t1], g[:, :, t0:t1]
        st = _fma(kv_dots(k, qt), scale, kb)                    # (keys, queries)
        kv_scores.append(st)
        mt, lt, dt = (x[:, :, t0:t1].transpose(-1, -2) for x in (m, l_run, delta))
        p = torch.exp(st - mt) * (1.0 / lt)
        ds = p * (kv_dots(v, gt) - dt)
        dv = dv + p @ gt
        dk = dk + (ds * scale if kround else ds) @ qt
    out = (dq, dk, dv) if kround else (dq * scale, dk * scale, dv)
    return out, torch.cat(dq_scores, -1), torch.cat(kv_scores, -1).transpose(-1, -2)


def _err(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


def _heads(Bn, Hn, Sn, D, seed, mask_kind="random"):
    """q, k, v, g (B, H, S, D) float32 and a key mask: random; "first_tile"
    masks every key of the first tile (a valid key comes later);
    "masked_sample" masks every key of the last sample."""
    r = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(r.randn(Bn, Hn, Sn, D).astype(np.float32))
                  for _ in range(4))
    mask = (r.rand(Bn, Sn) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if mask_kind == "first_tile":
        mask[:, :max(FWD_TILE, BWD_TILE)], mask[:, -3] = 0, 1
    elif mask_kind == "masked_sample":
        mask[-1] = 0
    return q, k, v, torch.from_numpy(mask), g


@pytest.mark.parametrize("Sn", [37, 130], ids=["S37", "S130"])
def test_model_matches_flash_masked_attention_and_its_vjp(Sn, monkeypatch):
    """The forward and the !kRound backward against flash_masked_attention
    and its VJP (pallas_attention.py:_attn_kernel, _attn_bwd_kernel)."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    q, k, v, mask, g = _heads(2, 3, Sn, 16, Sn)
    scale = 16 ** -0.5
    jm = jnp.asarray(mask.numpy())
    out, pullback = jax.vjp(lambda a, b, c: PA.flash_masked_attention(a, b, c, jm, scale),
                            *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    ref = pullback(jnp.asarray(g.numpy()))
    assert _err(fwd_model(q, k, v, mask, scale)[0], out) <= TOL
    for name, a, b in zip(("dq", "dk", "dv"), bwd_model(q, k, v, mask, g, scale, False)[0], ref):
        assert _err(a, b) <= TOL, (name, _err(a, b))


@pytest.mark.parametrize("residual", [True, False])
def test_model_inside_the_block_matches_pallas_block(residual, monkeypatch):
    """The forward as the attention of attn_half_plain against
    fused_attn_half_det (pallas_block.py:_attn_fwd_math), and the kRound
    backward as the core of attn_half_dx_plain against jax's gradient through
    pallas_block's dx kernel (_attn_bwd_math), interpret mode, fp32.  S = 37,
    C = 32, 4 heads, masked tail keys."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    i = _inputs(1)
    g = np.random.RandomState(9).randn(B, S, C).astype(np.float32)
    j = {name: jnp.asarray(a) for name, a in i.items()}
    rest = (j["mask"], j["ln_w"], j["ln_b"], j["wqkv"], j["bqkv"], j["wproj"], j["bproj"],
            H, (C // H) ** -0.5, EPS)
    out, vjp = jax.vjp(lambda x: PB.fused_attn_half_det(x, *rest, residual), j["x"])
    ref, = vjp(jnp.asarray(g))

    def dqkv(qkv, mask, wproj, gg, num_heads):
        Bn, Sn, C3 = qkv.shape
        D = C3 // 3 // num_heads
        q, k, v = qkv.reshape(Bn, Sn, 3, num_heads, D).permute(2, 0, 3, 1, 4)
        datt = (gg @ wproj).reshape(Bn, Sn, num_heads, D).transpose(1, 2)
        d = bwd_model(q, k, v, mask, datt, D ** -0.5, True)[0]
        return torch.stack(d).permute(1, 3, 0, 2, 4).reshape(Bn, Sn, C3)

    monkeypatch.setattr(FB, "mha", lambda q, k, v, mask, scale: fwd_model(q, k, v, mask,
                                                                          scale)[0])
    monkeypatch.setattr(FB, "_attn_dqkv_plain", dqkv)
    args = _attn_args(i)
    fwd = FB.attn_half_plain(*args, residual=residual)
    x, mask, lw, lb, wq, bq, wp, _, _, _ = args
    dx = FB.attn_half_dx_plain(x, mask, lw, lb, wq, bq, wp, torch.from_numpy(g), H, EPS,
                               residual)
    assert _err(fwd.numpy(), out) <= TOL, _err(fwd.numpy(), out)
    assert _err(dx.numpy(), ref) <= TOL, _err(dx.numpy(), ref)


CASES = ([(Sn, D, "random") for Sn in (1, 63, 64, 65, 241) for D in (32, 64, 128)]
         + [(241, 64, "first_tile"), (130, 64, "masked_sample")])


@pytest.mark.parametrize("Sn,D,mask_kind", CASES)
def test_model_matches_port_plain(Sn, D, mask_kind):
    """The forward against mha, the !kRound backward against
    masked_attention_bwd_plain and the kRound one against _attn_dqkv_plain
    with Wproj the identity, fp32; S around and past the tiles, D in the
    kernels' three widths, a fully masked first tile and a fully masked
    sample."""
    q, k, v, mask, g = _heads(2, 2, Sn, D, 7 + Sn + D, mask_kind)
    scale = D ** -0.5
    assert _err(fwd_model(q, k, v, mask, scale)[0], TA.mha(q, k, v, mask, scale)) <= TOL
    ref = TA.masked_attention_bwd_plain(q, k, v, mask, g, scale)
    for name, a, b in zip(("dq", "dk", "dv"), bwd_model(q, k, v, mask, g, scale, False)[0], ref):
        assert _err(a, b) <= TOL, (name, _err(a, b))
    qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(2, Sn, 3 * 2 * D)
    gb = g.transpose(1, 2).reshape(2, Sn, 2 * D)
    ref = FB._attn_dqkv_plain(qkv, mask, torch.eye(2 * D), gb, 2)
    ours = torch.stack(bwd_model(q, k, v, mask, g, scale, True)[0]).permute(1, 3, 0, 2, 4)
    assert _err(ours.reshape(2, Sn, 6 * D), ref) <= TOL


@pytest.mark.parametrize("kround", [False, True], ids=["core", "block"])
@pytest.mark.parametrize("mask_kind", ["random", "first_tile"])
def test_probe_reads_one_ds_from_both_backward_walks(mask_kind, kround):
    """At ViLT's D = 64 and a ragged S = 241, the probe reads the same ds
    bits from the model's bwd_dq walk (dq) and bwd_dkv walk (dk), and from
    the plain version, which computes ds once; a bwd_dkv that sums d in
    reverse order gives other bits, which the probe sees."""
    q, k, v, mask, g = _heads(2, 2, 241, 64, 3, mask_kind)
    s0, t0 = one_hot_probe(q, k, mask, 16, 5)
    scale = 64 ** -0.5
    dq, dk, _ = bwd_model(q, k, v, mask, g, scale, kround)[0]
    at_q, at_k = probe_ds(dq, dk, s0, t0)
    assert torch.equal(at_q, at_k) and bool((at_q != 0).any())
    plain = probe_ds(*TA.masked_attention_bwd_plain(q, k, v, mask, g, scale)[:2], s0, t0)
    assert torch.equal(*plain)
    flipped = bwd_model(q, k, v, mask, g, scale, kround,
                        kv_dots=lambda a, b: _dots(a.flip(-1), b.flip(-1)))[0]
    assert not torch.equal(*probe_ds(dq, flipped[1], s0, t0))
