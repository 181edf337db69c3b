"""The port's block ops (rmcl_tpu_torch/ops/fused_block.py) against the
JAX package: its Pallas kernels in interpret mode and their XLA twins, on
CPU, at S = 37 (not a multiple of any tile) with masked keys: the forwards,
the dx-only backwards against jax's gradient through the Pallas dx kernels,
and the autograd Functions.  The CUDA kernels are held against the plain
versions in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu_torch.ops import fused_block as FB
from tests._torch_threads import one_thread  # noqa: F401

B, S, C, H = 2, 37, 32, 4
EPS = 1e-6
ATOL = 3e-5      # as tests/test_pallas.py holds the Pallas kernels to their twins
# dx against jax.grad through the Pallas dx kernels, relative to max(1, max|ref|)
# in fp32 (summation order, and erff against the Pallas body's 1.5e-7 erf
# approximation) and to max|ref| in bf16 (rounding points agree; ties do not)
DX_RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
ZERO_LAUNCHES = dict.fromkeys(FB.launches, 0)


def _inputs(seed):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, C).astype(np.float32)
    mask = (r.rand(B, S) > 0.3).astype(np.int32)
    mask[:, 0] = 1           # a CLS-like key every row can attend to
    mask[:, -7:] = 0         # several padded keys at the tail
    f = lambda *shape: (0.1 * r.randn(*shape)).astype(np.float32)  # noqa: E731
    return dict(x=x, mask=mask, ln_w=1.0 + f(C), ln_b=f(C),
                wqkv=f(C, 3 * C), bqkv=f(3 * C), wproj=f(C, C), bproj=f(C),
                w1=f(C, 4 * C), b1=f(4 * C), w2=f(4 * C, C), b2=f(C))


@pytest.fixture(scope="module")
def inp():
    return _inputs(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attn_args(i, dev="cpu", dtype=torch.float32):
    """Port argument order; weights transposed to torch (out, in) layout."""
    return (_t(i["x"]).to(dev, dtype), _t(i["mask"]).to(dev),
            _t(i["ln_w"]).to(dev), _t(i["ln_b"]).to(dev),
            _t(i["wqkv"].T).to(dev, dtype), _t(i["bqkv"]).to(dev),
            _t(i["wproj"].T).to(dev, dtype), _t(i["bproj"]).to(dev), H, EPS)


def _mlp_args(i, dev="cpu", dtype=torch.float32):
    return (_t(i["x"]).to(dev, dtype), _t(i["ln_w"]).to(dev), _t(i["ln_b"]).to(dev),
            _t(i["w1"].T).to(dev, dtype), _t(i["b1"]).to(dev),
            _t(i["w2"].T).to(dev, dtype), _t(i["b2"]).to(dev), EPS)


@pytest.mark.parametrize("residual", [True, False])
def test_attn_half_plain_matches_pallas_and_twin(inp, residual, monkeypatch):
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    jargs = (j["x"], j["mask"], j["ln_w"], j["ln_b"], j["wqkv"], j["bqkv"],
             j["wproj"], j["bproj"], H, (C // H) ** -0.5, EPS)
    pallas = np.asarray(PB.fused_attn_half_det(*jargs, residual))
    twin = np.asarray(PB._xla_twin(*jargs) + (j["x"] if residual else 0.0))
    ours = FB.attn_half_plain(*_attn_args(inp), residual=residual).numpy()
    np.testing.assert_allclose(ours, pallas, atol=ATOL)
    np.testing.assert_allclose(ours, twin, atol=ATOL)


@pytest.mark.parametrize("residual", [True, False])
def test_mlp_half_plain_matches_pallas_and_twin(inp, residual, monkeypatch):
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    jargs = (j["x"], j["ln_w"], j["ln_b"], j["w1"], j["b1"], j["w2"], j["b2"], EPS)
    pallas = np.asarray(PB.fused_mlp_half(*jargs, residual))
    twin = np.asarray(PB._mlp_twin(*jargs) + (j["x"] if residual else 0.0))
    ours = FB.mlp_half_plain(*_mlp_args(inp), residual=residual).numpy()
    np.testing.assert_allclose(ours, pallas, atol=ATOL)
    np.testing.assert_allclose(ours, twin, atol=ATOL)


def test_public_ops_on_cpu_run_plain_and_count_nothing(inp):
    FB.reset_launches()
    assert torch.equal(FB.attn_half(*_attn_args(inp)),
                       FB.attn_half_plain(*_attn_args(inp)))
    assert torch.equal(FB.mlp_half(*_mlp_args(inp)),
                       FB.mlp_half_plain(*_mlp_args(inp)))
    assert FB.launches == ZERO_LAUNCHES


def test_public_ops_raise_off_cpu_and_cuda(inp):
    """Neither plain nor kernel on another device: the ops raise."""
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        FB.attn_half(*_attn_args(inp, dev="meta"))
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        FB.mlp_half(*_mlp_args(inp, dev="meta"))
    assert FB.launches == ZERO_LAUNCHES


# ------------------------------------------------------------- dx-only backward
def _dx_inputs(mask_kind, dtype):
    i = dict(_inputs(1))
    if mask_kind == "masked_sample":     # every key of sample 1 masked: uniform P
        i["mask"] = i["mask"].copy()
        i["mask"][1] = 0
    g = np.random.RandomState(9).randn(B, S, C).astype(np.float32)
    jdt = jnp.dtype(dtype)
    j = {k: jnp.asarray(v) for k, v in i.items()}
    j["x"], gj = j["x"].astype(jdt), jnp.asarray(g).astype(jdt)
    return i, j, gj, torch.from_numpy(g).to(getattr(torch, dtype))


def _check_dx(ours, ref, dtype):
    ours, ref = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(ours).all()
    scale = np.abs(ref).max()
    tol = DX_RTOL[dtype] * (max(1.0, scale) if dtype == "float32" else scale)
    assert np.abs(ours - ref).max() <= tol, (np.abs(ours - ref).max(), tol)


@pytest.mark.parametrize("mask_kind", ["ragged", "masked_sample"])
@pytest.mark.parametrize("residual", [True, False])
def test_attn_half_dx_plain_matches_jax_grad(residual, mask_kind, monkeypatch):
    """fp32 only: this jaxlib's CPU backend has no bf16 batched dot for the
    Pallas body in interpret mode.  A sample whose keys are all masked is
    held against the gradient of the unpadded XLA twin: the Pallas wrapper
    pads S to 128 with masked keys, so its uniform P also spreads over the
    padding, which the port (that masks its own ragged edge) does not have."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    dtype = "float32"
    i, j, gj, g = _dx_inputs(mask_kind, dtype)
    rest = (j["mask"], j["ln_w"], j["ln_b"], j["wqkv"], j["bqkv"], j["wproj"],
            j["bproj"], H, (C // H) ** -0.5, EPS)
    if mask_kind == "ragged":
        _, vjp = jax.vjp(lambda x: PB.fused_attn_half_det(x, *rest, residual), j["x"])
    else:
        _, vjp = jax.vjp(lambda x: PB._xla_twin(x, *rest) + (x if residual else 0.0),
                         j["x"])
    ref, = vjp(gj)
    tdt = getattr(torch, dtype)
    x, mask, lw, lb, wq, bq, wp, bp, _, _ = _attn_args(i, dtype=tdt)
    ours = FB.attn_half_dx_plain(x, mask, lw, lb, wq, bq, wp, g, H, EPS, residual)
    _check_dx(ours, ref, dtype)
    qkv = FB._attn_fwd_plain(x, mask, lw, lb, wq, bq, wp, bp, H, EPS, residual)[1]
    saved = FB.attn_half_dx_plain(x, mask, lw, lb, wq, bq, wp, g, H, EPS, residual, qkv)
    assert torch.equal(saved, ours)      # the saved qkv is the recomputed one


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
def test_mlp_half_dx_plain_matches_jax_grad(residual, dtype, monkeypatch):
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    i, j, gj, g = _dx_inputs("ragged", dtype)
    rest = (j["ln_w"], j["ln_b"], j["w1"], j["b1"], j["w2"], j["b2"], EPS, residual)
    _, vjp = jax.vjp(lambda x: PB.fused_mlp_half(x, *rest), j["x"])
    ref, = vjp(gj)
    tdt = getattr(torch, dtype)
    x, lw, lb, w1, b1, w2, b2, _ = _mlp_args(i, dtype=tdt)
    ours = FB.mlp_half_dx_plain(x, lw, lb, w1, b1, w2, g, EPS, residual)
    _check_dx(ours, ref, dtype)
    h = FB._mlp_fwd_plain(x, lw, lb, w1, b1, w2, b2, EPS, residual)[1]
    assert torch.equal(FB.mlp_half_dx_plain(x, lw, lb, w1, b1, w2, g, EPS, residual, h),
                       ours)


@pytest.mark.parametrize("save", [True, False], ids=["saved", "recompute"])
@pytest.mark.parametrize("residual", [True, False])
def test_functions_backward_is_the_plain_dx_on_cpu(inp, residual, save):
    """autograd through attn_half and mlp_half on CPU tensors returns exactly
    the plain dx, and agrees with autograd through the plain forwards."""
    g = torch.from_numpy(np.random.RandomState(3).randn(B, S, C).astype(np.float32))
    a, m = _attn_args(inp), _mlp_args(inp)
    x = a[0].clone().requires_grad_(True)
    FB.reset_launches()
    dx, = torch.autograd.grad(
        FB.attn_half(x, *a[1:], residual=residual, save_for_backward=save), x, g)
    assert torch.equal(dx, FB.attn_half_dx_plain(*a[:7], g, H, EPS, residual))
    ref, = torch.autograd.grad(FB.attn_half_plain(x, *a[1:], residual=residual), x, g)
    np.testing.assert_allclose(dx.numpy(), ref.numpy(), atol=ATOL)

    dx, = torch.autograd.grad(
        FB.mlp_half(x, *m[1:], residual=residual, save_for_backward=save), x, g)
    assert torch.equal(dx, FB.mlp_half_dx_plain(*m[:6], g, EPS, residual))
    ref, = torch.autograd.grad(FB.mlp_half_plain(x, *m[1:], residual=residual), x, g)
    np.testing.assert_allclose(dx.numpy(), ref.numpy(), atol=ATOL)
    assert FB.launches == ZERO_LAUNCHES


@pytest.mark.parametrize("which", ["ln_w", "wqkv", "bproj", "w1", "b2"])
def test_ops_refuse_weight_gradients(inp, which):
    """x is the only input the ops differentiate to: a parameter that
    requires grad raises, on the CPU too, and not under no_grad."""
    names_a = ("x", "mask", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
    names_m = ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")
    for op, names, args in ((FB.attn_half, names_a, list(_attn_args(inp))),
                            (FB.mlp_half, names_m, list(_mlp_args(inp)))):
        if which not in names:
            continue
        k = names.index(which)
        args[k] = args[k].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="x only"):
            op(*args)
        with torch.no_grad():
            op(*args)
