"""The port's task_moco training step (rmcl_tpu_torch/train, ops/philox.py,
ops/fused_block_train.py, objectives/contrastive.py) against the JAX package on
the same weights, batch and dropout masks, on the CPU in fp32 at a tiny size
(2 layers, C = 32 or 64, queue 16 x 128).

The TPU training kernels draw their masks from the TPU's own generator, which
has no CPU lowering, so the plain versions are held against the JAX package's
twins with an explicit keep mask (``_mlp_train_twin``, ``_xla_twin``), fed
the port's mask, and at p = 0 against ``fused_attn_half`` / ``fused_mlp_half``
in interpret mode.  On the CPU every port op runs its plain version.

Tolerances.  fp32 forward and gradients: 1e-5 * max(1, max|ref|) per tensor
(summation order).  Parameters after an AdamW step: see ``_close_params``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _fake_batch
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.models import vit as JV
from rmcl_tpu.models.vilt import init_vilt, make_spec
from rmcl_tpu.objectives import contrastive as JC
from rmcl_tpu.ops import pallas_block as PB
from rmcl_tpu.train import schedule as JS
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax, state_dict_from_jax
from rmcl_tpu_torch.models.vilt import ViLT, draw_seeds
from rmcl_tpu_torch.objectives import contrastive as TC
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.ops import fused_block_train as FT
from rmcl_tpu_torch.ops import philox
from rmcl_tpu_torch.train import schedule as TS
from rmcl_tpu_torch.train import step as TT
from tests._torch_threads import one_thread  # noqa: F401

EPS = 1e-6
RTOL = 1e-5


def _close(name, ours, ref, rtol=RTOL):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = np.abs(ours - ref).max() if ref.size else 0.0
    assert err <= rtol * max(1.0, np.abs(ref).max() if ref.size else 0.0), (name, err)


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ philox
def _np_philox(counter, key, rounds=10):
    """Philox-4x32 written from the round function, numpy uint64 arithmetic."""
    c = [np.uint64(v) for v in counter]
    k = [np.uint64(v) for v in key]
    M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask = np.uint64(0xFFFFFFFF)
    for r in range(rounds):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & mask, (k[1] + np.uint64(0xBB67AE85)) & mask]
        p0, p1 = M0 * c[0], M1 * c[2]          # < 2**64: exact in uint64
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & mask]
    return [int(v) for v in c]


# Random123's known-answer vectors for philox4x32-10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        "d16cfe09 94fdcceb 5001e420 24126ea1")]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    out = philox.philox4x32(tuple(map(t, counter)), tuple(map(t, key)))
    assert " ".join(f"{int(o):08x}" for o in out) == want
    assert " ".join(f"{o:08x}" for o in _np_philox(counter, key)) == want


def test_philox_matches_numpy_and_is_geometry_free():
    r = np.random.RandomState(0)
    seeds = r.randint(-2 ** 31, 2 ** 31, 3).astype(np.int32)
    bits = philox.random_bits(torch.from_numpy(seeds), 1, 7, 9).numpy()
    for b, row, col in ((0, 0, 0), (1, 3, 8), (2, 6, 5)):
        want = _np_philox((col, row, 1, 0), (int(seeds[b]) & 0xFFFFFFFF, 0))[0]
        assert int(bits[b, row, col]) == want
    # a sub-block of a larger draw is the same bits: no dependence on the shape
    big = philox.random_bits(torch.from_numpy(seeds[1:]), 1, 20, 33).numpy()
    assert np.array_equal(big[:, :7, :9], bits[1:])


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1 - 2.0 ** -32])
def test_keep_threshold_rule(p):
    assert philox.keep_threshold(p) == PB._keep_threshold(p)
    assert 0 <= philox.keep_threshold(p) <= 2 ** 32 - 1


def test_keep_mask_rate_and_streams():
    seeds = torch.tensor([3, -3, 3], dtype=torch.int32)
    m = philox.keep_mask(seeds, 0, 64, 512, 0.1)
    assert abs(m.float().mean().item() - 0.9) < 0.005
    assert bool(philox.keep_mask(seeds, 0, 8, 8, 0.0).all())
    assert torch.equal(m[0], m[2]) and not torch.equal(m[0], m[1])     # seed
    assert not torch.equal(m, philox.keep_mask(seeds, 1, 64, 512, 0.1))  # draw
    with pytest.raises(ValueError):
        philox.keep_mask(seeds, 0, 2, 2, 1.0)


# --------------------------------------------------- the two training halves
def _half_inputs(B=3, S=20, C=64, H=4, seed=0, dtype=np.float32):
    r = np.random.RandomState(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, S - 6:] = 0                                  # padded text positions
    f = lambda *s, std=0.05: (std * r.randn(*s)).astype(dtype)  # noqa: E731
    return dict(
        x=r.randn(B, S, C).astype(dtype), mask=mask,
        seeds=r.randint(-2 ** 31, 2 ** 31, B).astype(np.int32),
        ln_w=(1.0 + 0.1 * r.randn(C)).astype(dtype), ln_b=f(C, std=0.1),
        wqkv=f(C, 3 * C), bqkv=f(3 * C), wproj=f(C, C), bproj=f(C),   # JAX (in, out)
        w1=f(C, 4 * C), b1=f(4 * C), w2=f(4 * C, C), b2=f(C),
        g=r.randn(B, S, C).astype(dtype), H=H)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


ATTN_NAMES = ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
MLP_NAMES = ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")
MATRICES = ("wqkv", "wproj", "w1", "w2")


def _torch_args(inp, names):
    """Leaves that require grad, matrices transposed to torch's (out, in)."""
    return [_t(inp[n].T if n in MATRICES else inp[n], grad=True) for n in names]


def _compare_grads(names, ours, ref):
    for n, a, b in zip(names, ours, ref):
        _close(f"d{n}", a.T if n in MATRICES else a, b)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("tail", [False, True], ids=["notail", "tail"])
def test_mlp_half_train_matches_jax_twin(p, tail):
    """mlp_half_train (forward, and all seven gradients through its autograd
    function and mlp_half_train_bwd) against ``_mlp_train_twin`` fed the port's
    masks; with ``tail`` the twin is composed with the second mask and the
    residual as scripts/validate_train_attn_kernel.py composes it."""
    inp = _half_inputs()
    B, S, C = inp["x"].shape
    seeds = _t(inp["seeds"])
    keep = philox.keep_mask(seeds, 0, S, 4 * C, p).numpy().astype(np.float32)
    keep2 = philox.keep_mask(seeds, 1, S, C, p).numpy().astype(np.float32)

    def twin(x, ln_w, ln_b, w1, b1, w2, b2):
        f = PB._mlp_train_twin(x, keep, ln_w, ln_b, w1, b1, w2, b2, p, EPS)
        return x + keep2 * f / (1.0 - p) if tail else f

    jargs = [jnp.asarray(inp[n]) for n in MLP_NAMES]
    ref = twin(*jargs)
    ref_g = jax.jit(jax.grad(lambda *a: jnp.sum(twin(*a) * inp["g"]),
                             argnums=tuple(range(7))))(*jargs)

    targs = _torch_args(inp, MLP_NAMES)
    out = FT.mlp_half_train(targs[0], seeds, *targs[1:], p, EPS, tail)
    _close("forward", out, ref)
    _compare_grads(MLP_NAMES, torch.autograd.grad(out, targs, _t(inp["g"])), ref_g)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
def test_attn_half_train_matches_jax_twin(p):
    """attn_half_train against ``x + keep * _xla_twin(...) / (1 - p)``
    (scripts/validate_train_attn_kernel.py), forward and seven gradients.  One
    sample is fully masked: its rows attend uniformly over the S keys (the
    -1e30 bias is finite) in both, and contribute alike to every gradient."""
    inp = _half_inputs()
    inp["mask"][2] = 0
    B, S, C = inp["x"].shape
    H = inp["H"]
    seeds, mask = _t(inp["seeds"]), _t(inp["mask"])
    keep = philox.keep_mask(seeds, 0, S, C, p).numpy().astype(np.float32)

    def twin(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj):
        f = PB._xla_twin(x, jnp.asarray(inp["mask"]), ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                         H, (C // H) ** -0.5, EPS)
        return x + keep * f / (1.0 - p)

    jargs = [jnp.asarray(inp[n]) for n in ATTN_NAMES]
    ref = twin(*jargs)
    ref_g = jax.jit(jax.grad(lambda *a: jnp.sum(twin(*a) * inp["g"]),
                             argnums=tuple(range(7))))(*jargs)

    targs = _torch_args(inp, ATTN_NAMES)
    out = FT.attn_half_train(targs[0], seeds, mask, *targs[1:], H, EPS, p)
    _close("forward", out, ref)
    _compare_grads(ATTN_NAMES, torch.autograd.grad(out, targs, _t(inp["g"])), ref_g)


def test_train_halves_at_p0_match_pallas_interpret(monkeypatch):
    """At p = 0 the training ops compute ``x + fused_attn_half`` and
    ``x + fused_mlp_half(residual=False)``; the Pallas kernels run in interpret
    mode, the backward through their own custom_vjp.  (No fully masked
    sample here: the TPU kernels pad S to 128 with masked keys, so such a
    sample attends uniformly over 128 keys there and over S elsewhere.)"""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    inp = _half_inputs(S=24)
    B, S, C = inp["x"].shape
    H = inp["H"]
    seeds, mask = _t(inp["seeds"]), _t(inp["mask"])

    def j_attn(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj):
        return x + PB.fused_attn_half(x, jnp.asarray(inp["mask"]), ln_w, ln_b, wqkv, bqkv,
                                      wproj, bproj, H, (C // H) ** -0.5, EPS)

    def j_mlp(x, ln_w, ln_b, w1, b1, w2, b2):
        return PB.fused_mlp_half(x, ln_w, ln_b, w1, b1, w2, b2, EPS, True)

    for names, jfn, op in ((ATTN_NAMES, j_attn,
                            lambda x, *a: FT.attn_half_train(x, seeds, mask, *a, H, EPS, 0.0)),
                           (MLP_NAMES, j_mlp,
                            lambda x, *a: FT.mlp_half_train(x, seeds, *a, 0.0, EPS))):
        jargs = [jnp.asarray(inp[n]) for n in names]
        ref = jax.jit(jfn)(*jargs)
        ref_g = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * inp["g"]),
                                 argnums=tuple(range(7))))(*jargs)
        targs = _torch_args(inp, names)
        out = op(*targs)
        _close("forward", out, ref)
        _compare_grads(names, torch.autograd.grad(out, targs, _t(inp["g"])), ref_g)


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_train_plain_bf16_tracks_fp32(half):
    """bf16 plain versions against the fp32 ones on the same masks, within
    bf16 rounding: 3e-2 * max|ref| per tensor (8 mantissa bits through a
    chain of four rounded products).  The JAX CPU backend lacks the bf16
    batched dot of these bodies; bf16 kernels are held on the card."""
    inp = _half_inputs()
    H, p = inp["H"], 0.1
    seeds, mask = _t(inp["seeds"]), _t(inp["mask"])
    names = ATTN_NAMES if half == "attn" else MLP_NAMES

    def run(dtype):
        a = [_t(inp[n].T if n in MATRICES else inp[n]) for n in names]
        x = a[0].to(dtype)
        a = [x] + [t.to(dtype) if n in MATRICES else t for n, t in zip(names[1:], a[1:])]
        g = _t(inp["g"]).to(dtype)
        if half == "attn":
            x, lw, lb, wq, bq, wp, bp = a
            out, qkv, att, _ = FT._attn_train_fwd(x, seeds, mask, lw, lb, wq, bq, wp, bp,
                                                  H, EPS, p)
            return (out, *FT.attn_half_train_bwd(x, seeds, mask, lw, lb, wq, wp, g, qkv,
                                                 att, H, EPS, p))
        x, lw, lb, w1, b1, w2, b2 = a
        out, h, a_d, _, _ = FT._mlp_train_fwd(x, seeds, lw, lb, w1, b1, w2, b2, EPS, p, True)
        return (out, *FT.mlp_half_train_bwd(x, seeds, lw, lb, w1, w2, g, h, a_d, p, EPS))

    for i, (lo, hi) in enumerate(zip(run(torch.bfloat16), run(torch.float32))):
        assert lo.dtype == (torch.bfloat16 if i < 2 else torch.float32)
        err = (lo.float() - hi).abs().max().item()
        assert err <= 3e-2 * hi.abs().max().item(), (i, err)


def test_training_ops_on_cpu_count_nothing_and_check_p():
    inp = _half_inputs(B=2, S=8, C=32)
    a = _torch_args(inp, ATTN_NAMES)
    FB.reset_launches()
    out, keep = FT.attn_half_train(a[0], _t(inp["seeds"]), _t(inp["mask"]), *a[1:],
                                   inp["H"], EPS, 0.3, emit_mask=True)
    assert keep.dtype == torch.bool and not out.requires_grad
    assert torch.equal(keep, philox.keep_mask(_t(inp["seeds"]), 0, 8, 32, 0.3))
    assert FB.launches == dict.fromkeys(FB.launches, 0)
    with pytest.raises(ValueError, match="dropout rate"):
        FT.attn_half_train(a[0], _t(inp["seeds"]), _t(inp["mask"]), *a[1:], inp["H"],
                           EPS, 1.0)


# ------------------------------------------------------------- model setup
def _cfg(**kw):
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=16,
        image_size=32, image_bucket_hw=(32, 48), max_text_len=12,
        vocab_size=64, loss_names=loss_names({"moco": 1}), num_negative=16,
        momentum=0.99, temperature=0.07, use_pallas_attention=False,
        compute_dtype="float32", drop_rate=0.0, max_image_len=4, image_dtype="float32",
        image_view=True, text_view=True, adv_steps_img=2, adv_lr_img=0.05,
        adv_max_norm_img=0.005, learning_rate=1e-3, weight_decay=0.01, lr_mult=10,
        max_steps=100, warmup_steps=0)
    base.update(kw)
    return build_config(**base)


def _port_of(cfg, params, state):
    model = ViLT(cfg)
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers, state).items()}) == []
    return model


def _perturbed(params, seed=0):
    """Twins that differ from the query side, and LayerNorms off (1, 0)."""
    r = np.random.RandomState(seed)
    return jax.tree.map(lambda a: a + jnp.asarray(0.02 * r.randn(*a.shape), a.dtype), params)


def test_vit_training_forward_matches_jax():
    """ViT.forward with seeds at p = 0 (the training ops) against
    ``transformer_apply(deterministic=False)`` with ``drop_rate=0``: output
    and the gradient of every transformer parameter and of the input."""
    vit_training_matches_jax(_cfg())


def vit_training_matches_jax(cfg):
    """The body of ``test_vit_training_forward_matches_jax`` for a config; the
    JAX package and the port read the same block configuration from it."""
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    params = _perturbed(params)
    model = _port_of(cfg, params, state)
    r = np.random.RandomState(1)
    B, S, C = 3, 17, cfg.hidden_size
    x, g = r.randn(B, S, C).astype(np.float32), r.randn(B, S, C).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, 12:] = 0

    def jfn(tr, xx):
        return JV.transformer_apply(tr, xx, jnp.asarray(mask), spec=make_spec(cfg),
                                    rng=jax.random.PRNGKey(3), deterministic=False)

    ref = jax.jit(jfn)(params["transformer"], jnp.asarray(x))
    g_tr, g_x = jax.jit(jax.grad(lambda tr, xx: jnp.sum(jfn(tr, xx) * g), argnums=(0, 1)))(
        params["transformer"], jnp.asarray(x))

    xt = _t(x, grad=True)
    seeds = draw_seeds(torch.Generator().manual_seed(0), 1, cfg.num_layers, B, "cpu")[0, :-1]
    out = model.transformer(xt, _t(mask), None, seeds, 0.0)
    _close("forward", out, ref)
    (out * _t(g)).sum().backward()
    _close("dx", xt.grad, g_x)
    ours, want = leaves_to_jax(model.transformer, grads=True), _jflat(g_tr)
    assert len(ours) == 14 and set(ours) <= set(want)   # 12 block leaves, the norm's two
    for path in want:
        if path in ours:
            _close(path, ours[path], want[path])
        else:                      # embeddings: not on this path, no gradient in the port
            assert not np.any(want[path]), path


# ---------------------------------------------------------------- schedule
def _jax_path(name, jlabels):
    path = re.sub(r"blocks\.\d+", "blocks", name).replace(".", "/")
    return path if path in jlabels else re.sub(r"weight$", "kernel", path)


def test_param_group_labels_match_jax():
    cfg = _cfg(loss_names=loss_names({"moco": 1, "vqa": 1, "mlm": 1}), vqav2_label_size=7)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    jlabels = _jflat(JS.param_group_labels(params))
    labels = TS.param_group_labels(_port_of(cfg, params, state))
    assert len(labels) > 50
    for name, label in labels.items():
        assert label == str(jlabels[_jax_path(name, jlabels)]), name
    assert {TS.BASE_DECAY, TS.BASE_NO_DECAY, TS.HEAD_DECAY, TS.HEAD_NO_DECAY,
            TS.FROZEN} == set(labels.values())


@pytest.mark.parametrize("decay,warmup", [(1, 10), (2.0, 0.1), ("cosine", 10), (1, 0)],
                         ids=["linear", "poly2-frac", "cosine", "nowarmup"])
def test_lr_schedule_matches_jax(decay, warmup):
    cfg = _cfg(decay_power=decay, warmup_steps=warmup, end_lr=1e-6, learning_rate=2e-4)
    js, ts = JS.make_lr_schedule(cfg, 100), TS.make_lr_schedule(cfg, 100)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 101):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5, atol=1e-12)
    if warmup:
        assert ts(0) == 0.0


def test_adamw_steps_match_optax():
    """Three updates on seeded gradients, warmup 2 (the first update has rate
    0), head group at 10x: every leaf within 1e-6 of optax's."""
    cfg = _cfg(warmup_steps=2)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    model = _port_of(cfg, params, state)
    tx, _ = JS.make_optimizer(cfg, params, 100)
    opt_state = tx.init(params)
    optimizer, scheduler, labels = TS.make_optimizer(cfg, model, 100)
    jpaths = {name: _jax_path(name, _jflat(params)) for name in labels}
    named = dict(model.named_parameters())
    for it in range(3):
        r = np.random.RandomState(10 + it)
        grads = jax.tree.map(lambda a: jnp.asarray(r.randn(*a.shape), a.dtype), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = state_dict_from_jax(grads, cfg.num_layers)
        for name, p in named.items():
            p.grad = torch.from_numpy(tgrads[name]) if labels[name] != TS.FROZEN else None
        optimizer.step()
        scheduler.step()
        ours, want = leaves_to_jax(model), _jflat(params)
        for path in want:
            np.testing.assert_allclose(ours[path], want[path], atol=1e-6, err_msg=path)
        if it == 0:       # rate 0: nothing moved
            np.testing.assert_array_equal(ours["pooler/dense/kernel"],
                                          _jflat(init_vilt(jax.random.PRNGKey(0), cfg)[0])[
                                              "pooler/dense/kernel"])
    assert set(jpaths.values()) <= set(want)


def test_make_optimizer_refuses_other_optimizers():
    """adamw, adam and sgd are the JAX package's optimizers
    (tests/test_torch_accum.py holds adam and sgd to optax); any other name
    raises as its make_optimizer does."""
    cfg = _cfg(optim_type="lamb")
    with pytest.raises(ValueError, match="unknown optim_type"):
        TS.make_optimizer(cfg, ViLT(cfg), 10)


# ------------------------------------------------------------- contrastive
def test_momentum_update_matches_jax():
    cfg = _cfg()
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    model = _port_of(cfg, params, state)
    TC.momentum_update(model, 0.9)
    ours, want = leaves_to_jax(model), _jflat(JC.momentum_update(params, 0.9))
    for path, ref in want.items():
        np.testing.assert_allclose(ours[path], ref, atol=1e-7, err_msg=path)
    assert not np.allclose(want["k_moco_head/projector/0/kernel"],
                           _jflat(params)["k_moco_head/projector/0/kernel"])


def test_dequeue_and_enqueue_matches_jax():
    """Three writes of 4 keys into a 12-wide queue from pointer 8: the third
    wraps.  A partial batch is skipped; K % B != 0 raises."""
    cfg = _cfg(num_negative=12)
    model = ViLT(cfg)
    r = np.random.RandomState(0)
    q0 = r.randn(128, 12).astype(np.float32)
    state = {"proj_queue": jnp.asarray(q0), "proj_queue_ptr": jnp.asarray(8, jnp.int32)}
    with torch.no_grad():
        model.proj_queue.copy_(_t(q0))
        model.proj_queue_ptr.fill_(8)
    for i in range(3):
        keys = r.randn(4, 128).astype(np.float32)
        state = JC.dequeue_and_enqueue(state, jnp.asarray(keys), 4)
        TC.dequeue_and_enqueue(model, _t(keys), 4)
        np.testing.assert_array_equal(model.proj_queue.numpy(), np.asarray(state["proj_queue"]))
        assert int(model.proj_queue_ptr) == int(state["proj_queue_ptr"]) == (12, 4, 8)[i] % 12
    before = model.proj_queue.clone()
    TC.dequeue_and_enqueue(model, _t(r.randn(3, 128).astype(np.float32)), 4)   # partial
    assert torch.equal(model.proj_queue, before) and int(model.proj_queue_ptr) == 8
    with pytest.raises(ValueError, match="divisible"):
        TC.dequeue_and_enqueue(model, _t(r.randn(5, 128).astype(np.float32)), 5)


def test_view_diagnostics_and_rows_match_jax():
    r = np.random.RandomState(0)
    q, k = r.randn(5, 128).astype(np.float32), r.randn(5, 128).astype(np.float32)
    queue = r.randn(128, 16).astype(np.float32)
    ours = TC._view_diagnostics(_t(q), _t(k), _t(queue), "txt")
    want = JC._view_diagnostics(jnp.asarray(q), jnp.asarray(k), jnp.asarray(queue), "txt")
    assert set(ours) == set(want) and len(want) == 6
    for key in want:
        np.testing.assert_allclose(ours[key].item(), float(want[key]), rtol=1e-5, err_msg=key)
    loss, logits = TC.infonce(_t(q), _t(k), _t(queue), 0.07)
    jloss, jlogits = JC.infonce(jnp.asarray(q), jnp.asarray(k), jnp.asarray(queue), 0.07)
    np.testing.assert_allclose(TC._infonce_rows(logits).numpy(),
                               np.asarray(JC._infonce_rows(jlogits)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TC._infonce_rows(logits).mean().item(), loss.item(), rtol=1e-6)


# ------------------------------------------------------ the slice as a whole
def _close_params(ours, want, grads, lr, what):
    """Leaves after an AdamW step.  Adam divides each gradient element by its
    own magnitude (+ 1e-8), so where a gradient is at rounding level (below
    1e-4 of its tensor's largest: e.g. the key bias, whose true gradient is
    0) its sign, and with it a step of up to the rate, is not determined;
    those elements are held to 2.5 * rate, every other one to 2% of the rate.
    Leaves the optimizer does not touch (twins, queue) are held to 1e-6."""
    assert set(ours) == set(want), what
    for path, ref in want.items():
        diff = np.abs(ours[path] - ref)
        if path not in grads:
            assert diff.max() <= 1e-6, (what, path, diff.max())
            continue
        scale = lr * (10 if "moco_head" in path else 1)
        g = np.abs(grads[path])
        firm = g > 1e-4 * max(g.max(), 1e-30)
        assert diff[firm].max(initial=0.0) <= 0.02 * scale, (what, path, diff[firm].max())
        assert diff.max() <= 2.5 * scale, (what, path, diff.max())


def test_two_moco_steps_match_jax():
    """Two task_moco steps (image and text views, attacked ids in the batch, 2
    PGD steps, drop_rate 0, warmup 0) against the JAX package's
    ``make_train_step`` on the same weights and batch: every scalar metric,
    total_loss and lr; the gradient of every parameter at step one; after each
    step every parameter, twin, the queue and the pointer."""
    two_moco_steps_match_jax(_cfg())


def two_moco_steps_match_jax(cfg):
    """The body of ``test_two_moco_steps_match_jax`` for a config; the JAX
    package and the port read the same block configuration from it."""
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    b = _fake_batch(cfg, 4, seed=1, with_views=True)
    b.pop("text_labels")
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = {k: _t(v) for k, v in b.items()}

    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=params,
                                            state=state)
    jstep = JT.make_train_step(cfg, jmodel, tx, donate=False)
    jgrads = _jflat(jax.jit(jax.grad(lambda p: JT.compute_all_tasks(
        cfg, jmodel, p, jts.state, jbatch, jax.random.PRNGKey(5), train=True)[0]))(jts.params))

    ts = TT.create_train_state(cfg, model=_port_of(cfg, params, state), device="cpu")
    step = TT.make_train_step(cfg, ts)
    gen = torch.Generator().manual_seed(0)
    for it in range(2):
        jts, jmetrics = jstep(jts, jbatch, jax.random.PRNGKey(5 + it))
        metrics = step(tbatch, gen)
        assert set(metrics) == set(jmetrics), set(metrics) ^ set(jmetrics)
        for key, ref in jmetrics.items():
            # step two starts from parameters that differ within _close_params' bounds
            np.testing.assert_allclose(metrics[key].item(), float(ref),
                                       rtol=1e-4 if it == 0 else 2e-3, atol=1e-5,
                                       err_msg=f"step {it} {key}")
        assert ts.step == int(jts.step) == it + 1
        if it == 0:
            tgrads = leaves_to_jax(ts.model, grads=True)
            for path, g in tgrads.items():
                _close(f"grad {path}", g, jgrads[path])
            assert float(metrics["pgd_delta"]) > 0 and abs(float(metrics["lr"]) - 1e-3) < 1e-9
        want = {**_jflat(jts.params), **_jflat(jts.state)}
        _close_params(leaves_to_jax(ts.model), want,
                      {p: g for p, g in jgrads.items() if not p.startswith("k_")},
                      1e-3, f"step {it}")
    assert int(ts.model.proj_queue_ptr) == 8
    # the cached block matrices follow the updated masters
    for blk, mats in zip(ts.model.transformer.blocks, ts.block_matrices):
        assert torch.equal(mats["wqkv"], blk.attn["qkv"].weight.detach())


def test_moco_step_with_dropout_owns_its_stream():
    """drop_rate 0.1: the masks are the port's own stream, so only what that
    allows is held: a finite loss, the same loss from the same generator
    seed, another for another seed, and dropout active in the query forward."""
    cfg = _cfg(drop_rate=0.1)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    b = _fake_batch(cfg, 4, seed=1, with_views=True)
    tbatch = {k: _t(v) for k, v in b.items() if k != "text_labels"}

    def one_step(seed):
        ts = TT.create_train_state(cfg, model=_port_of(cfg, params, state), device="cpu")
        m = TT.make_train_step(cfg, ts)(tbatch, torch.Generator().manual_seed(seed))
        return m["total_loss"].item(), ts

    (a, ts), (b_, _), (c, _) = one_step(0), one_step(0), one_step(1)
    assert np.isfinite(a) and a == b_ and a != c
    model = ts.model
    seeds = draw_seeds(torch.Generator().manual_seed(0), 1, cfg.num_layers, 4, "cpu")[0]
    with torch.no_grad():
        det = model.infer(tbatch)["cls_feats"]
        drop = model.infer(tbatch, deterministic=False, seeds=seeds)["cls_feats"]
    assert not torch.allclose(det, drop)
    with pytest.raises(ValueError, match="seeds"):
        model.infer(tbatch, deterministic=False)


def test_train_step_refuses_what_is_not_ported():
    ts = TT.create_train_state(_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="fuse_moco_views"):
        TT.make_train_step(_cfg(fuse_moco_views=True), ts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.create_train_state(_cfg())


def test_cli_points_training_at_make_train_step(capsys):
    """Training is the ``with`` form (tests/test_torch_trainer.py runs it);
    a name that is not a named config is refused with a pointer to
    ``configs``, and the usage text names the ``with`` form."""
    from rmcl_tpu_torch.cli.run import main
    assert main(["train", "with", "task_moco"]) == 2
    assert "rmcl_tpu_torch.cli.run configs" in capsys.readouterr().err
    assert main(["--help"]) == 0
    assert "cli.run with <named_config>" in capsys.readouterr().out
