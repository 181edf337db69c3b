"""The port's block ops (rmcl_tpu_torch/ops/fused_block.py) against the
JAX package: its Pallas kernels in interpret mode and their XLA twins, on
CPU in fp32, at S = 37 (not a multiple of any tile) with masked keys.
The CUDA kernels are held against the plain versions in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu_torch.ops import fused_block as FB

B, S, C, H = 2, 37, 32, 4
EPS = 1e-6
ATOL = 3e-5      # as tests/test_pallas.py holds the Pallas kernels to their twins


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
    assert FB.launches == {"attn_half": 0, "mlp_half": 0}


def test_public_ops_raise_off_cpu_and_cuda(inp):
    """Neither plain nor kernel on another device: the ops raise."""
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        FB.attn_half(*_attn_args(inp, dev="meta"))
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        FB.mlp_half(*_mlp_args(inp, dev="meta"))
    assert FB.launches == {"attn_half": 0, "mlp_half": 0}
