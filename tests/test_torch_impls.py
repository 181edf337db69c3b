"""The port's other block configurations against the JAX package, on the CPU
in fp32 at a tiny size: ``attention_impl="pallas"`` (the unfused block
around the attention-core op, ``rmcl_tpu/ops/pallas_attention.py``) and
``attention_impl="fused"`` with ``mlp_impl="fused"`` (``fused_attn_half`` and
its full backward, ``pallas_block.py:_bwd_impl``), and their ops
(``ops/attention.py:masked_attention``, ``ops/fused_block.py:attn_half_full``,
``ops/dropout.py``).

The Pallas kernels run in interpret mode (``RMCL_PALLAS_INTERPRET=1``); on the
CPU every port op runs its plain version.  This jaxlib has no bf16 batched
dot for the Pallas bodies in interpret mode, so everything here is fp32; the
bf16 kernels are held against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: fp32 forward and gradients 1e-5 * max(1, max|ref|) per tensor
(summation order).  The TPU kernels pad S to 128 with masked keys, so no
sample here has every key masked (it would attend over 128 keys there and
over S here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.ops import pallas_attention as PA
from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
from rmcl_tpu_torch.models import vit as TV
from rmcl_tpu_torch.models.layers import dropout as dropout_plain
from rmcl_tpu_torch.models.vilt import ViLT, derive_block_impls, draw_seeds
from rmcl_tpu_torch.ops import attention as TA
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.ops.dropout import dropout
from rmcl_tpu_torch.ops.philox import keep_mask
from rmcl_tpu_torch.train import step as TT
from tests.test_torch_train import (ATTN_NAMES, EPS, _cfg, _close, _compare_grads,
                                    _half_inputs, _port_of, _t, _torch_args,
                                    two_moco_steps_match_jax, vit_training_matches_jax)
from tests._torch_threads import one_thread  # noqa: F401

CONFIGS = {"default": {}, "F": dict(attention_impl="fused", mlp_impl="fused"),
           "P": dict(attention_impl="pallas")}


# ------------------------------------------------- rows 10 and 11: the core
def _heads(B, H, S, D, seed):
    r = np.random.RandomState(seed)
    q, k, v, g = (r.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = (r.rand(B, S) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, mask, g


@pytest.mark.parametrize("S", [37, 130], ids=["S37", "S130"])
def test_masked_attention_matches_pallas_interpret(S, monkeypatch):
    """The op's forward and its VJP to q, k and v against
    ``flash_masked_attention`` in interpret mode (its own custom_vjp, rows 10
    and 11), random key mask, ragged S; ``masked_attention_bwd_plain`` (row
    11's rounding points written out) against the same VJP."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    q, k, v, mask, g = _heads(2, 3, S, 16, seed=S)
    scale = 16 ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    ref, pullback = jax.vjp(
        lambda a, b, c: PA.flash_masked_attention(a, b, c, jnp.asarray(mask), scale), *jargs)
    ref_g = pullback(jnp.asarray(g))

    targs = [_t(a, grad=True) for a in (q, k, v)]
    FB.reset_launches()
    out = TA.masked_attention(*targs, _t(mask), scale)
    _close("forward", out, ref)
    for name, ours, want in zip("qkv", torch.autograd.grad(out, targs, _t(g)), ref_g):
        _close(f"d{name}", ours, want)
    plain = TA.masked_attention_bwd_plain(*map(_t, (q, k, v, mask, g)), scale)
    for name, ours, want in zip("qkv", plain, ref_g):
        _close(f"d{name} (bwd_plain)", ours, want)
    assert FB.launches == dict.fromkeys(FB.launches, 0)     # the CPU launches nothing


# --------------------------------------------- row 2: fused_attn_half's backward
def test_attn_half_full_matches_fused_attn_half(monkeypatch):
    """attn_half_full (plain: row 1's chain without the residual, and its
    autograd through attn_half_full_bwd_plain) against ``fused_attn_half`` in
    interpret mode (``_fwd_impl`` and ``_bwd_impl``): the output and the
    gradients of x and all six parameters; attn_half_full_bwd_plain called
    directly on the forward's qkv and attn against the same gradients."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    inp = _half_inputs(S=24)
    B, S, C = inp["x"].shape
    H = inp["H"]
    mask = _t(inp["mask"])

    def jfn(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj):
        return PB.fused_attn_half(x, jnp.asarray(inp["mask"]), ln_w, ln_b, wqkv, bqkv,
                                  wproj, bproj, H, (C // H) ** -0.5, EPS)

    jargs = [jnp.asarray(inp[n]) for n in ATTN_NAMES]
    ref = jax.jit(jfn)(*jargs)
    ref_g = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * inp["g"]),
                             argnums=tuple(range(7))))(*jargs)

    targs = _torch_args(inp, ATTN_NAMES)
    out = FB.attn_half_full(targs[0], mask, *targs[1:], H, EPS)
    _close("forward", out, ref)
    _compare_grads(ATTN_NAMES, torch.autograd.grad(out, targs, _t(inp["g"])), ref_g)

    x, lw, lb, wq, bq, wp, bp = (t.detach() for t in targs)
    _, qkv, attn = FB._attn_fwd(x, mask, lw, lb, wq, bq, wp, bp, H, EPS, False)
    grads = FB.attn_half_full_bwd_plain(x, mask, lw, lb, wq, wp, _t(inp["g"]), qkv, attn,
                                        H, EPS)
    _compare_grads(ATTN_NAMES, grads, ref_g)


def test_attn_half_full_returns_grads_in_param_types():
    """fp32 masters with cached operands: every parameter gradient comes back
    float32; without the cached operands the op casts them itself."""
    inp = _half_inputs(B=2, S=8, C=32)
    targs = _torch_args(inp, ATTN_NAMES)
    x, lw, lb, wq, bq, wp, bp = targs
    out = FB.attn_half_full(x, _t(inp["mask"]), lw, lb, wq, bq, wp, bp, inp["H"], EPS,
                            wqkv_c=wq.detach().clone(), wproj_c=wp.detach().clone())
    grads = torch.autograd.grad(out.sum(), targs)
    assert all(gr.dtype == torch.float32 and gr.shape == t.shape
               for gr, t in zip(grads, targs))
    with torch.no_grad():
        same = FB.attn_half_full(x, _t(inp["mask"]), lw, lb, wq, bq, wp, bp, inp["H"], EPS)
    assert torch.equal(same, out.detach())


# ------------------------------------------------------------------ dropout
def test_dropout_op_is_the_kernels_convention():
    """ops/dropout.py on the CPU: keep_mask of (seed, draw, row, column) and
    layers.dropout, bit for bit, in both directions; x itself at p = 0."""
    r = np.random.RandomState(0)
    seeds = _t(r.randint(-2 ** 31, 2 ** 31, 3).astype(np.int32))
    x = _t(r.randn(3, 7, 16).astype(np.float32), grad=True)
    g = _t(r.randn(3, 7, 16).astype(np.float32))
    keep = keep_mask(seeds, 1, 7, 16, 0.3)
    out = dropout(x, seeds, 1, 0.3)
    assert torch.equal(out, dropout_plain(x.detach(), keep, 0.3))
    assert torch.equal(torch.autograd.grad(out, x, g)[0], dropout_plain(g, keep, 0.3))
    assert dropout(x, seeds, 1, 0.0) is x
    with pytest.raises(ValueError, match="dropout rate"):
        dropout(x, seeds, 1, 1.0)


def test_embedding_dropouts_give_the_bits_of_the_earlier_path(monkeypatch):
    """A training step at drop_rate 0.1 under the default configuration gives
    the same loss, bit for bit, with the embedding dropouts through the new op
    and through the earlier path (keep_mask + layers.dropout on the whole
    embedding)."""
    import rmcl_tpu_torch.models.vilt as TVilt
    from __graft_entry__ import _fake_batch
    cfg = _cfg(drop_rate=0.1)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    b = _fake_batch(cfg, 4, seed=1, with_views=True)
    tbatch = {k: _t(v) for k, v in b.items() if k != "text_labels"}

    def loss():
        ts = TT.create_train_state(cfg, model=_port_of(cfg, params, state), device="cpu")
        m = TT.make_train_step(cfg, ts)(tbatch, torch.Generator().manual_seed(0))
        return m["total_loss"].item()

    new = loss()
    monkeypatch.setattr(TVilt, "dropout", lambda x, seeds, draw, p: dropout_plain(
        x, keep_mask(seeds, draw, *x.shape[1:], p), p))
    assert np.isfinite(new) and loss() == new


# ------------------------------------------------------------ ViT and step
@pytest.mark.parametrize("config", ["F", "P"])
def test_vit_training_matches_jax_under_config(config, monkeypatch):
    """ViT.forward with seeds at p = 0 against ``transformer_apply(
    deterministic=False)`` with the same block configuration: config F runs
    ``fused_attn_half`` and ``fused_mlp_half`` in interpret mode (the port:
    attn_half_full and mlp_half_train at p = 0), config P ``mha_xla`` on the
    CPU (the port: the unfused block around masked_attention).  Output and the
    gradient of every transformer parameter and of the input."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    vit_training_matches_jax(_cfg(**CONFIGS[config]))


@pytest.mark.parametrize("config", ["F", "P"])
def test_two_moco_steps_match_jax_under_config(config, monkeypatch):
    """``test_two_moco_steps_match_jax`` (tests/test_torch_train.py) under the
    two other configurations, the JAX package given the same knobs (config F
    in interpret mode): key forward, PGD, four views, AdamW, enqueue."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    two_moco_steps_match_jax(_cfg(**CONFIGS[config]))


def test_configurations_agree_at_dropout():
    """drop_rate 0.1: one step from the same weights, batch and generator seed
    under the default configuration (dropout inside attn_half_train and
    mlp_half_train), F (attn_half_full, the plain MLP, dropout outside) and P
    (the unfused block): the same loss and the same gradient of every
    parameter, to fp32 summation order.  All dropouts share the kernels' mask
    convention."""
    from __graft_entry__ import _fake_batch
    results = {}
    for name, impls in CONFIGS.items():
        cfg = _cfg(drop_rate=0.1, **impls)
        params, state = init_vilt(jax.random.PRNGKey(0), cfg)
        b = _fake_batch(cfg, 4, seed=1, with_views=True)
        tbatch = {k: _t(v) for k, v in b.items() if k != "text_labels"}
        ts = TT.create_train_state(cfg, model=_port_of(cfg, params, state), device="cpu")
        m = TT.make_train_step(cfg, ts)(tbatch, torch.Generator().manual_seed(0))
        results[name] = (m["total_loss"].item(), leaves_to_jax(ts.model, grads=True))
    loss, grads = results["default"]
    assert np.isfinite(loss)
    for name in ("F", "P"):
        other_loss, other = results[name]
        np.testing.assert_allclose(other_loss, loss, rtol=1e-5, err_msg=name)
        assert set(other) == set(grads)
        for path, ref in grads.items():
            _close(f"{name} {path}", other[path], ref)


# ------------------------------------------------------------ derivation
@pytest.mark.parametrize("attn,mlp,want", [
    ("", "", ("fused", "fused_train")),
    ("fused", "fused", ("fused", "fused")),
    ("pallas", "", ("pallas", "fused_train")),
    ("flash", "fused", ("flash", "fused")),
], ids=["default", "F", "P", "flash"])
def test_derive_block_impls(attn, mlp, want):
    assert derive_block_impls(_cfg(attention_impl=attn, mlp_impl=mlp)) == want
    model = ViLT(_cfg(attention_impl=attn, mlp_impl=mlp, loss_names={"moco": 1}))
    for tr in (model.transformer, model.k_transformer):
        assert all((blk.attn_impl, blk.mlp_impl) == want for blk in tr.blocks)


@pytest.mark.parametrize("attn,mlp,err", [
    ("xla", "", NotImplementedError), ("xla_bf16", "", NotImplementedError),
    ("", "xla", NotImplementedError), ("splash", "", ValueError), ("", "fast", ValueError),
])
def test_derive_block_impls_refuses(attn, mlp, err):
    with pytest.raises(err, match="Not ported" if err is NotImplementedError else "unknown"):
        derive_block_impls(_cfg(attention_impl=attn, mlp_impl=mlp))


@pytest.mark.parametrize("attn", ["pallas", "flash"])
def test_unfused_configurations_route_to_the_attention_core_op(attn, monkeypatch):
    """"pallas" and "flash" (row 12, the library flash kernel: the same
    function on every row read) both run the unfused block through
    ``masked_attention``, deterministic and training; "fused" never does."""
    calls = []
    real = TV.masked_attention

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(TV, "masked_attention", spy)
    cfg = _cfg(attention_impl=attn)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    model = _port_of(cfg, params, state)
    x, mask = torch.randn(2, 9, cfg.hidden_size), torch.ones(2, 9, dtype=torch.int32)
    seeds = draw_seeds(torch.Generator().manual_seed(0), 1, cfg.num_layers, 2, "cpu")[0, :-1]
    with torch.no_grad():
        model.transformer(x, mask)
        model.transformer(x, mask, None, seeds, 0.1)
    assert len(calls) == 2 * cfg.num_layers and calls[0] == (2, cfg.num_heads, 9, 16)
    calls.clear()
    fused = _port_of(_cfg(), params, state)
    with torch.no_grad():
        fused.transformer(x, mask)
    assert not calls
