"""A tile model of the bf16 attention forward kernel
(``rmcl_tpu_torch/csrc/hopper_attention.cuh:fwd_kernel``), on the CPU, against
the JAX package and the port's plain versions.

The model is written here, not in the package: it walks 64-key tiles with the
online row statistics (running max m, running sum l of e = exp(s - m) in
fp32), rescales the output rows by alpha = exp(m_old - m_new), adds E . V with
e rounded to bf16 (the kernel's A fragments) and fp32 sums, and divides by l
at the end.  That is where the kernel rounds; the Pallas kernels and the
port's ``mha`` round the normalised p = e / sum e instead.  Inputs are numpy
from a seed.  The Pallas kernels run in interpret mode
(``RMCL_PALLAS_INTERPRET=1``) in fp32, as ``tests/test_torch_ops.py`` runs
them (this jaxlib has no bf16 batched dot for their bodies).

Tolerances:
  * In fp32 (e not rounded) against ``flash_masked_attention``'s forward
    (``pallas_attention.py:_attn_kernel``) and, as the core of
    ``attn_half_plain``, against ``fused_attn_half_det``
    (``pallas_block.py:_attn_fwd_math``) and ``_xla_twin``: 2e-5 relative to
    max(1, max|ref|), summation order only.  Rounding e to bf16 misses that
    tolerance, which the first test shows.
  * With the bf16 rounding of e, on bf16 inputs, against the port's plain
    ``mha`` (p rounded after the division; outputs rounded to bf16): within
    one bf16 ulp (8e-3) of the largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.ops import pallas_attention as PA
from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu_torch.ops import attention as TA
from rmcl_tpu_torch.ops import fused_block as FB
from tests.test_torch_ops import C, EPS, H, _attn_args, _inputs
from tests._torch_threads import one_thread  # noqa: F401

TILE = 64
NEG_BIAS = -1e30


def _bf16(x):
    return x.bfloat16().float()


def tile_model(q, k, v, mask, scale, rounding="bf16"):
    """The output in fp32, before its rounding, of the forward kernel on
    (B, H, S, D) float32 operands.  ``rounding``: "bf16", e rounded to bf16
    before E . V (the kernel); "fp32", none."""
    Bn, Hn, Sn, D = q.shape
    bias = torch.where(mask > 0, 0.0, NEG_BIAS)[:, None, None, :]
    rnd = _bf16 if rounding == "bf16" else (lambda x: x)
    m = torch.full((Bn, Hn, Sn, 1), -float("inf"))
    l_run = torch.zeros(Bn, Hn, Sn, 1)
    o = torch.zeros(Bn, Hn, Sn, D)
    for t0 in range(0, Sn, TILE):
        t1 = min(t0 + TILE, Sn)
        s = q @ k[:, :, t0:t1].transpose(-1, -2) * scale + bias[..., t0:t1]
        mx = torch.maximum(m, s.max(-1, keepdim=True).values)
        alpha = torch.exp(m - mx)
        e = torch.exp(s - mx)
        l_run = l_run * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + rnd(e) @ v[:, :, t0:t1]
        m = mx
    return o * (1.0 / l_run)


def _err(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


def _heads(Bn, Hn, Sn, D, seed, mask_kind="random"):
    """q, k, v (B, H, S, D) rounded to bf16 values, and a key mask: random;
    "first_tile" masks every key of the first 64-key tile (a valid key comes
    later); "masked_sample" masks every key of the last sample."""
    r = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(r.randn(Bn, Hn, Sn, D).astype(np.float32)).bfloat16()
               for _ in range(3))
    mask = (r.rand(Bn, Sn) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if mask_kind == "first_tile":
        mask[:, :TILE], mask[:, -3] = 0, 1
    elif mask_kind == "masked_sample":
        mask[-1] = 0
    return q, k, v, torch.from_numpy(mask)


@pytest.mark.parametrize("Sn,mask_kind", [(37, "random"), (130, "random"),
                                          (130, "first_tile")])
def test_model_matches_flash_masked_attention(Sn, mask_kind, monkeypatch):
    """fp32, e not rounded, against flash_masked_attention's forward
    (pallas_attention.py:_attn_kernel): within 2e-5.  With e rounded to bf16
    the model misses that tolerance."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    q, k, v, mask = _heads(2, 3, Sn, 16, Sn, mask_kind)
    q, k, v = (t.float() for t in (q, k, v))
    scale = 16 ** -0.5
    ref = np.asarray(PA.flash_masked_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(mask.numpy()), scale))
    ours = tile_model(q, k, v, mask, scale, rounding="fp32")
    rounded = tile_model(q, k, v, mask, scale)
    assert _err(ours, ref) <= 2e-5, _err(ours, ref)
    assert _err(rounded, ref) > 2e-5


@pytest.mark.parametrize("residual", [True, False])
def test_model_inside_attn_half_matches_pallas_and_twin(residual, monkeypatch):
    """The model (fp32) as the attention of attn_half_plain, the LayerNorm,
    qkv and proj around it as they are, against fused_attn_half_det
    (pallas_block.py:_attn_fwd_math, interpret mode) and _xla_twin in fp32:
    within 2e-5.  S = 37, C = 32, 4 heads, masked tail keys."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    i = _inputs(0)
    j = {name: jnp.asarray(a) for name, a in i.items()}
    jargs = (j["x"], j["mask"], j["ln_w"], j["ln_b"], j["wqkv"], j["bqkv"], j["wproj"],
             j["bproj"], H, (C // H) ** -0.5, EPS)
    pallas = np.asarray(PB.fused_attn_half_det(*jargs, residual))
    twin = np.asarray(PB._xla_twin(*jargs) + (j["x"] if residual else 0.0))
    monkeypatch.setattr(FB, "mha", lambda q, k, v, mask, scale: tile_model(
        q.float(), k.float(), v.float(), mask, scale, rounding="fp32").to(v.dtype))
    ours = FB.attn_half_plain(*_attn_args(i), residual=residual).numpy()
    assert _err(ours, pallas) <= 2e-5, _err(ours, pallas)
    assert _err(ours, twin) <= 2e-5, _err(ours, twin)


@pytest.mark.parametrize("Sn,D,mask_kind", [
    (1, 64, "random"), (37, 8, "random"), (63, 64, "random"), (64, 64, "random"),
    (65, 64, "random"), (130, 64, "random"), (241, 64, "random"), (269, 64, "random"),
    (130, 64, "first_tile"), (241, 64, "first_tile"), (130, 64, "masked_sample"),
    (241, 64, "masked_sample"), (130, 128, "random")])
def test_model_matches_port_plain_in_bf16(Sn, D, mask_kind):
    """In bf16, the model with the kernel's rounding points against the
    port's plain mha (p rounded after the division), both outputs rounded to
    bf16: within one bf16 ulp (8e-3) of the largest output."""
    q, k, v, mask = _heads(2, 2, Sn, D, 7 + Sn, mask_kind)
    scale = D ** -0.5
    ours = tile_model(q.float(), k.float(), v.float(), mask, scale).bfloat16().float()
    ref = TA.mha(q, k, v, mask, scale).float()
    err = (ours - ref).abs().max().item()
    assert err <= 8e-3 * ref.abs().max().item(), err
