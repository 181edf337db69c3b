"""Order models of the LayerNorm backward (``ln_bwd``) and the column sums
(``colsum``) of ``rmcl_tpu_torch/csrc/block_kernels.cu``, on the CPU, against
the JAX package and the port's plain versions.

The models are written here, not in the package.  They add in the kernels'
orders, in fp32, and round where the kernels round:
  * ``ln_bwd`` (one warp per row): each lane adds its 8-column chunks at
    columns 8 l + 256 j in chunk order, the warp adds its 32 lanes by a
    butterfly (xor 16, 8, 4, 2, 1), for the mean, the variance, sum dyh and
    sum dyh xhat; dx = rstd (dyh - m1 - xhat m2) [+ g] and y = xhat ln_w +
    ln_b, each cast once.  Training: a CTA of 8 warps owns row blocks of 16
    rows (warp w rows 2 w and 2 w + 1) and walks the blocks b, b + grid, ...;
    a warp adds dy xhat and dy over its rows in order, the CTA its warps in
    warp order, a cluster of 4 CTAs its CTAs in rank order, and the clusters'
    slabs are added in cluster order.  The grid is the kernel's: at most one
    wave of clusters, which the device decides, so the tests take it as a
    parameter.
  * ``colsum`` (a cluster of 8 CTAs per 64-column strip): rank r takes the
    rows [r R, (r + 1) R), R = ceil(M / 8); row lane l of 256 V / 64 adds
    the rows l, l + lanes, ... (V = 16 bytes / element size); the row lanes
    are added in a tree (lane l takes lane l + s, s = lanes / 2, ..., 1) and
    the ranks in rank order.

Each model is held to two references:
  (a) the JAX package in fp32, the sums of the block halves' backwards:
      row 2's (``fused_attn_half``'s VJP) and rows 3 and 5's dx
      (``fused_attn_half_det``, ``fused_mlp_half``) with the Pallas kernels in
      interpret mode (``RMCL_PALLAS_INTERPRET=1``); rows 9 and 7 at p = 0
      through ``fused_attn_half`` / ``fused_mlp_half`` in interpret mode, and
      at p = 0.1 through their XLA twins (``_xla_twin``, ``_mlp_train_twin``)
      fed the port's keep masks, since the training kernels draw their masks
      from the TPU's generator, which has no CPU lowering.  The models go in
      for ``_ln_backward_plain`` and ``_colsum_plain`` under the port's plain
      ops.  Tolerance 1e-5 of max(1, max|ref|): summation order only.
  (b) the port's ``_ln_backward_plain`` and ``_colsum_plain`` on bf16
      inputs: dx and y (bf16) within one bf16 ulp of max|ref|, the fp32 sums
      within 1e-5 of max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.ops import fused_block_train as FT
from rmcl_tpu_torch.ops import philox
from tests.test_torch_train import ATTN_NAMES, MATRICES, MLP_NAMES, _half_inputs, _t
from tests._torch_threads import one_thread  # noqa: F401

EPS = 1e-6
LANES, CHUNK, WIDTH = 32, 8, 256          # ln_bwd: lanes, chunk, columns per chunk round
WARPS, RPW, LN_CLUSTER = 8, 2, 4          # ln_bwd training form
CS_THREADS, CS_COLS, CS_CLUSTER = 256, 64, 8   # colsum


# ------------------------------------------------------------------ models
def _warp_sum(terms):
    """(M, C) terms of a row sum: each lane adds its chunks' in order, then
    the butterfly across the 32 lanes.  Columns past C add nothing (the
    kernel skips them)."""
    M, C = terms.shape
    nj = -(-C // WIDTH)
    lanes = F.pad(terms, (0, nj * WIDTH - C)).view(M, nj, LANES, CHUNK)
    lanes = lanes.permute(0, 2, 1, 3).reshape(M, LANES, nj * CHUNK)
    s = torch.zeros(M, LANES)
    for k in range(nj * CHUNK):
        s = s + lanes[:, :, k]
    idx = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    return s[:, :1]


def ln_bwd_grid(M, max_clusters):
    """The training form's CTAs for M rows when the device runs
    ``max_clusters`` clusters at once."""
    blocks = -(-M // (WARPS * RPW))
    return min(-(-blocks // LN_CLUSTER), max_clusters) * LN_CLUSTER


def _ln_column_sums(terms, grid):
    """Sums over the rows of (M, N) terms in the training form's order."""
    M, N = terms.shape
    rows = WARPS * RPW
    rounds = -(-M // (rows * grid))
    t = F.pad(terms, (0, 0, 0, rounds * grid * rows - M)).view(rounds, grid, WARPS, RPW, N)
    p = None
    for k in range(rounds):                 # a warp's rows, in order
        for i in range(RPW):
            p = t[k, :, :, i] if p is None else p + t[k, :, :, i]
    cta = p[:, 0]
    for w in range(1, WARPS):               # the CTA's warps, in warp order
        cta = cta + p[:, w]
    ranks = cta.view(grid // LN_CLUSTER, LN_CLUSTER, N)
    slab = ranks[:, 0]
    for r in range(1, LN_CLUSTER):          # the cluster's CTAs, in rank order
        slab = slab + ranks[:, r]
    out = slab[0]
    for q in range(1, slab.shape[0]):       # the clusters' slabs, in cluster order
        out = out + slab[q]
    return out


def ln_bwd_model(x2d, dy, ln_w, ln_b, g2d, eps, residual, max_clusters=64):
    """(dx, y, dln_w, dln_b) as ``ln_bwd`` computes them; the signature of
    ``_ln_backward_plain``."""
    M, C = x2d.shape
    x32, dy = x2d.float(), dy.float()
    mean = _warp_sum(x32) / C
    xc = x32 - mean
    rstd = 1.0 / torch.sqrt(_warp_sum(xc * xc) / C + eps)
    xhat = xc * rstd
    dyh = dy * ln_w
    m1, m2 = _warp_sum(dyh) / C, _warp_sum(dyh * xhat) / C
    dx = rstd * (dyh - m1 - xhat * m2)
    if residual:
        dx = dx + g2d.float()
    dln = _ln_column_sums(torch.cat([dy * xhat, dy], 1), ln_bwd_grid(M, max_clusters))
    return dx.to(x2d.dtype), (xhat * ln_w + ln_b).to(x2d.dtype), dln[:C], dln[C:]


def colsum_model(a2d):
    """Column sums of (M, N) as ``colsum`` adds them; the signature of
    ``_colsum_plain``."""
    M, N = a2d.shape
    groups = CS_COLS // (16 // a2d.element_size())
    lanes = CS_THREADS // groups
    a = a2d.float()
    R = -(-M // CS_CLUSTER)
    out = None
    for r in range(CS_CLUSTER):
        share = a[r * R:min(M, (r + 1) * R)]
        k = -(-share.shape[0] // lanes)
        share = F.pad(share, (0, 0, 0, k * lanes - share.shape[0])).view(k, lanes, N)
        acc = torch.zeros(lanes, N)
        for i in range(k):                  # a row lane's rows, in order
            acc = acc + share[i]
        s = lanes // 2
        while s:                            # the row lanes' tree
            acc = torch.cat([acc[:s] + acc[s:2 * s], acc[s:]])
            s //= 2
        out = acc[0] if out is None else out + acc[0]   # the ranks, in order
    return out


def _use_models(monkeypatch, max_clusters):
    """The models in place of the plain versions under the port's plain ops."""
    model = lambda *a: ln_bwd_model(*a, max_clusters=max_clusters)  # noqa: E731
    for mod in (FB, FT):
        monkeypatch.setattr(mod, "_ln_backward_plain", model)
        monkeypatch.setattr(mod, "_colsum_plain", colsum_model)


def _err(ours, ref):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else ours
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


# ------------------------------------- (a) against the JAX package in fp32
# C = 768 (ViLT-B/32's width, 12 heads) and C = 32 (4 heads: one chunk, 28
# of 32 lanes without columns); bias gradients at 4 C and 3 C wide
WIDTHS = [(768, 12), (32, 4)]


def _inputs(C, H):
    inp = _half_inputs(B=3, S=20, C=C, H=H, seed=C)
    inp["mask"][2, :7] = 0                   # padded keys at the front of one sample
    return inp


def _jax_grads(fn, inp, names, argnums):
    jargs = [jnp.asarray(inp[n]) for n in names]
    return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * inp["g"]), argnums=argnums))(*jargs)


def _jax_dx(fn, x, g):
    """The input gradient of ``fn`` at ``x`` for the output gradient ``g``,
    compiled."""
    return jax.jit(lambda xx, gg: jax.vjp(fn, xx)[1](gg)[0])(x, jnp.asarray(g))


def _torch_leaves(inp, names):
    return [_t(inp[n].T if n in MATRICES else inp[n]) for n in names]


@pytest.mark.parametrize("max_clusters", [64, 1], ids=["one_wave", "one_cluster"])
@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda v: str(v))
def test_model_in_row2_matches_fused_attn_half(C, H, max_clusters, monkeypatch):
    """Row 2 (``_bwd_impl``, Pallas in interpret mode): dx, dln_w, dln_b,
    dbqkv and dbproj of ``attn_half_full_bwd_plain`` with the models."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    inp = _inputs(C, H)
    mask = jnp.asarray(inp["mask"])

    def jfn(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj):
        return PB.fused_attn_half(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, H,
                                  (C // H) ** -0.5, EPS)

    ref = _jax_grads(jfn, inp, ATTN_NAMES, (0, 1, 2, 4, 6))
    x, lw, lb, wq, bq, wp, bp = _torch_leaves(inp, ATTN_NAMES)
    _, qkv, attn = FB._attn_fwd(x, _t(inp["mask"]), lw, lb, wq, bq, wp, bp, H, EPS, False)
    _use_models(monkeypatch, max_clusters)
    dx, dlw, dlb, _, dbq, _, dbp = FB.attn_half_full_bwd_plain(
        x, _t(inp["mask"]), lw, lb, wq, wp, _t(inp["g"]), qkv, attn, H, EPS)
    for name, ours, want in zip(("dx", "dln_w", "dln_b", "dbqkv", "dbproj"),
                                (dx, dlw, dlb, dbq, dbp), ref):
        assert _err(ours, want) <= 1e-5, (name, _err(ours, want))


@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda v: str(v))
def test_model_in_dx_rows_matches_pallas(C, H, monkeypatch):
    """Rows 3 and 5 (``_dx_bwd_impl``, ``_mlp_dx_impl``, Pallas in interpret
    mode): dx of ``attn_half_dx_plain`` and ``mlp_half_dx_plain`` with the
    model's dx-only form."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    inp = _inputs(C, H)
    j = {n: jnp.asarray(inp[n]) for n in ATTN_NAMES + MLP_NAMES + ("mask",)}
    ref_attn = _jax_dx(lambda x: PB.fused_attn_half_det(
        x, j["mask"], j["ln_w"], j["ln_b"], j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], H,
        (C // H) ** -0.5, EPS, True), j["x"], inp["g"])
    ref_mlp = _jax_dx(lambda x: PB.fused_mlp_half(
        x, j["ln_w"], j["ln_b"], j["w1"], j["b1"], j["w2"], j["b2"], EPS, True), j["x"], inp["g"])
    x, lw, lb, wq, bq, wp, _ = _torch_leaves(inp, ATTN_NAMES)
    _, _, _, w1, b1, w2, _ = _torch_leaves(inp, MLP_NAMES)
    g = _t(inp["g"])
    _use_models(monkeypatch, 64)
    ours_attn = FB.attn_half_dx_plain(x, _t(inp["mask"]), lw, lb, wq, bq, wp, g, H, EPS, True)
    ours_mlp = FB.mlp_half_dx_plain(x, lw, lb, w1, b1, w2, g, EPS, True)
    assert _err(ours_attn, ref_attn) <= 1e-5, _err(ours_attn, ref_attn)
    assert _err(ours_mlp, ref_mlp) <= 1e-5, _err(ours_mlp, ref_mlp)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda v: str(v))
def test_model_in_rows_9_and_7_matches_jax(C, H, p, monkeypatch):
    """Rows 9 and 7 (the training backwards): dx, dln_w, dln_b and the two
    bias gradients of ``attn_half_train_bwd_plain`` and
    ``mlp_half_train_bwd_plain`` with the models.  p = 0: ``x +
    fused_attn_half`` and ``fused_mlp_half`` (Pallas, interpret mode); p =
    0.1: the XLA twins fed the port's masks."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    inp = _inputs(C, H)
    B, S, _ = inp["x"].shape
    mask, seeds = jnp.asarray(inp["mask"]), _t(inp["seeds"])
    keep = philox.keep_mask(seeds, 0, S, C, p).numpy().astype(np.float32)
    keep1 = philox.keep_mask(seeds, 0, S, 4 * C, p).numpy().astype(np.float32)
    keep2 = philox.keep_mask(seeds, 1, S, C, p).numpy().astype(np.float32)

    def j_attn(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj):
        if p == 0.0:
            return x + PB.fused_attn_half(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, H,
                                          (C // H) ** -0.5, EPS)
        f = PB._xla_twin(x, mask, ln_w, ln_b, wqkv, bqkv, wproj, bproj, H,
                         (C // H) ** -0.5, EPS)
        return x + keep * f / (1.0 - p)

    def j_mlp(x, ln_w, ln_b, w1, b1, w2, b2):
        if p == 0.0:
            return PB.fused_mlp_half(x, ln_w, ln_b, w1, b1, w2, b2, EPS, True)
        f = PB._mlp_train_twin(x, keep1, ln_w, ln_b, w1, b1, w2, b2, p, EPS)
        return x + keep2 * f / (1.0 - p)

    ref_attn = _jax_grads(j_attn, inp, ATTN_NAMES, (0, 1, 2, 4, 6))
    ref_mlp = _jax_grads(j_mlp, inp, MLP_NAMES, (0, 1, 2, 4, 6))
    x, lw, lb, wq, bq, wp, bp = _torch_leaves(inp, ATTN_NAMES)
    _, _, _, w1, b1, w2, b2 = _torch_leaves(inp, MLP_NAMES)
    g, tmask = _t(inp["g"]), _t(inp["mask"])
    _, qkv, attn, _ = FT._attn_train_fwd_plain(x, seeds, tmask, lw, lb, wq, bq, wp, bp, H,
                                               EPS, p)
    _, h, a_d, _, _ = FT._mlp_train_fwd_plain(x, seeds, lw, lb, w1, b1, w2, b2, EPS, p, True)
    _use_models(monkeypatch, 1)
    ours_attn = FT.attn_half_train_bwd_plain(x, seeds, tmask, lw, lb, wq, wp, g, qkv, attn,
                                             H, EPS, p)
    ours_mlp = FT.mlp_half_train_bwd_plain(x, seeds, lw, lb, w1, w2, g, h, a_d, p, EPS, True)
    names = ("dx", "dln_w", "dln_b", "db_first", "db_second")
    for what, ours, ref in (("attn", ours_attn, ref_attn), ("mlp", ours_mlp, ref_mlp)):
        for name, o, want in zip(names, (ours[0], ours[1], ours[2], ours[4], ours[6]), ref):
            assert _err(o, want) <= 1e-5, (what, name, _err(o, want))


# ----------------------------- (b) against the port's plain versions in bf16
def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("residual", [True, False], ids=["g", "nog"])
@pytest.mark.parametrize("M,max_clusters", [(74, 64), (3856, 64), (3856, 30), (700, 2)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("C", [32, 264, 768], ids=lambda c: f"C{c}")
def test_ln_bwd_model_matches_plain_in_bf16(C, M, max_clusters, residual):
    """The model on bf16 x and g against ``_ln_backward_plain``: C = 264
    leaves a ragged second chunk (lane 0 only); M = 3,856 the step's rows in
    one wave (61 clusters) and in two rounds of 30, M = 700 CTAs that walk
    six row blocks each."""
    r = np.random.RandomState(C + M)
    f = lambda *s, mu=0.0, sd=1.0: torch.from_numpy(  # noqa: E731
        (mu + sd * r.randn(*s)).astype(np.float32))
    x, g = f(M, C, mu=0.5, sd=2.0).bfloat16(), f(M, C).bfloat16()
    dy, ln_w, ln_b = f(M, C), f(C, mu=1.0, sd=0.1), f(C, sd=0.1)
    ours = ln_bwd_model(x, dy, ln_w, ln_b, g, EPS, residual, max_clusters)
    ref = FB._ln_backward_plain(x, dy, ln_w, ln_b, g, EPS, residual)
    for name, o, want in zip(("dx", "y", "dln_w", "dln_b"), ours, ref):
        assert o.dtype == want.dtype and o.shape == want.shape, name
        err = (o.float() - want.float()).abs().max().item()
        ref_max = want.float().abs().max().item()
        tol = _bf16_ulp(ref_max) if o.dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("M", [5, 74, 3856], ids=lambda m: f"M{m}")
@pytest.mark.parametrize("N", [768, 776, 2304, 3072], ids=lambda n: f"N{n}")
def test_colsum_model_matches_plain(N, M, dtype):
    """The model against ``_colsum_plain`` (a.float().sum(0)): the four bias
    gradients' widths and a ragged strip (776); M = 5 leaves ranks without
    rows; 1e-5 of max(1, max|ref|)."""
    r = np.random.RandomState(N + M)
    a = torch.from_numpy((0.5 + r.randn(M, N)).astype(np.float32)).to(dtype)
    ours, ref = colsum_model(a), FB._colsum_plain(a)
    assert ours.dtype == torch.float32 and ours.shape == (N,)
    err = (ours - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err


def test_models_follow_their_own_order():
    """The models are not the plain sums: at the step's rows the orders give
    other bits, and the training form's order depends on the grid."""
    r = np.random.RandomState(5)
    a = torch.from_numpy(r.randn(3856, 768).astype(np.float32))
    assert not torch.equal(colsum_model(a), a.sum(0))
    assert not torch.equal(_ln_column_sums(a, ln_bwd_grid(3856, 64)),
                           _ln_column_sums(a, ln_bwd_grid(3856, 30)))
