"""The port's PGD image attacks (rmcl_tpu_torch/attacks/pgd.py) against the
JAX package's on the same weights and batch, on CPU in fp32 at a tiny size
(2 layers, C = 32, 6 patches of which 4 are selected).

Tolerance on the perturbation: 1e-5 absolute.  Each step adds
adv_lr * g / max|g| and clips to +-max_norm = 0.005, so a relative
difference of 1e-5 in g (summation order) moves an unclipped component by at
most 0.05 * 1e-5; a near-tie in max|g| between two components changes the
divisor by the same relative amount, no more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _fake_batch
from rmcl_tpu.attacks import pgd as JP
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.models import heads as JH
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.objectives.losses import l2_normalize as jax_l2_normalize
from rmcl_tpu_torch.attacks import pgd as TP
from rmcl_tpu_torch.compat.from_jax import state_dict_from_jax
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.objectives.contrastive import infonce
from rmcl_tpu_torch.objectives.losses import l2_normalize
from tests._torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
STEPS, LR, NORM, TEMP = 3, 0.05, 0.005, 0.07


def _cfg(losses, **kw):
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=16,
        image_size=32, image_bucket_hw=(32, 48), max_text_len=12,
        vocab_size=64, loss_names=loss_names(losses), num_negative=16,
        temperature=TEMP, use_pallas_attention=False, compute_dtype="float32",
        drop_rate=0.0, vqav2_label_size=7, max_image_len=4, image_dtype="float32")
    base.update(kw)
    return build_config(**base)


def _setup(cfg, B=3, seed=0):
    """JAX params and state, the port with the same weights, and one
    patch-row batch with ragged valid sizes, as numpy."""
    params, state = init_vilt(jax.random.PRNGKey(seed), cfg)
    # make the momentum twins differ from the query side, as after training
    r = np.random.RandomState(seed)
    params = {k: (jax.tree.map(lambda a: a + jnp.asarray(0.02 * r.randn(*a.shape), a.dtype), v)
                  if k.startswith("k_") else v) for k, v in params.items()}
    model = ViLT(cfg)
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers, state).items()}) == []
    b = _fake_batch(cfg, B, seed=seed + 1)
    b = {k: b[k] for k in ("image", "text_ids", "text_masks")}
    assert b["image"].ndim == 3                      # patch rows
    return params, state, model, b


def _t(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _moco_keys(cfg, params, model, b):
    ik = ViLTModel(cfg).infer_k(params, _j(b), deterministic=True)
    k_j = jax_l2_normalize(JH.moco_head(params["k_moco_head"], ik["cls_feats"]), 1)
    with torch.inference_mode():
        k_t = l2_normalize(model.k_moco_head(model.infer_k(_t(b))["cls_feats"]), 1)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=2e-5)
    return k_j, torch.from_numpy(np.array(k_j))


@pytest.mark.parametrize("jax_impl", ["default", "fused"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
def test_pgd_moco_matches_jax(fast, jax_impl, monkeypatch):
    """delta of make_pgd_moco after 3 steps, against the JAX package running
    its XLA blocks and its fused Pallas half-block kernels (forward and
    dx-only backward, in interpret mode)."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    impl = {} if jax_impl == "default" else dict(attention_impl="fused", mlp_impl="fused")
    cfg = _cfg({"moco": 1}, **impl)
    params, state, model, b = _setup(cfg)
    k_j, k_t = _moco_keys(cfg, params, model, b)
    ref = jax.jit(JP.make_pgd_moco(ViLTModel(cfg), STEPS, LR, NORM, TEMP, fast=fast))(
        params, _j(b), k_j, state["proj_queue"])
    ours = TP.make_pgd_moco(model, STEPS, LR, NORM, TEMP, fast=fast)(
        _t(b), k_t, model.proj_queue)
    assert tuple(ours.shape) == b["image"].shape
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_pgd_fast_matches_slow():
    """Hoisted-geometry PGD equals the path that embeds image + delta afresh
    in every iteration, with max_image_len selecting 4 of 6 patches: the
    gradient is exactly zero on padding and unselected patches."""
    cfg = _cfg({"moco": 1})
    params, _, model, b = _setup(cfg, seed=2)
    _, k = _moco_keys(cfg, params, model, b)
    args = (STEPS, LR, NORM, TEMP)
    d_fast = TP.make_pgd_moco(model, *args, fast=True)(_t(b), k, model.proj_queue)
    d_slow = TP.make_pgd_moco(model, *args, fast=False)(_t(b), k, model.proj_queue)
    np.testing.assert_allclose(d_fast.numpy(), d_slow.numpy(), atol=1e-6, rtol=1e-5)


def test_pgd_moco_bounds_ascent_and_support():
    """Linf bound, the attack moved, the loss went up, delta is zero on
    padding and on unselected patches, and the model's parameters require
    grad again afterwards."""
    cfg = _cfg({"moco": 1})
    params, _, model, b = _setup(cfg, B=4, seed=3)
    _, k = _moco_keys(cfg, params, model, b)
    tb = _t(b)
    delta = TP.make_pgd_moco(model, STEPS, LR, NORM, TEMP)(tb, k, model.proj_queue)
    d = delta.numpy()
    assert np.isfinite(d).all() and 0 < np.abs(d).max() <= NORM + 1e-6
    prep = model.transformer.visual_embed_prepare(tb["image"], cfg.grid_hw,
                                                  cfg.max_image_len)
    live = np.zeros(d.shape[:2], bool)
    np.put_along_axis(live, prep.sel.numpy(), prep.x_mask[:, 1:].numpy() > 0, axis=1)
    assert (d[~live] == 0).all() and (np.abs(d[live]).max(axis=-1) > 0).all()
    assert all(p.requires_grad for p in model.parameters())

    def loss_of(img):
        with torch.inference_mode():
            q = l2_normalize(model.moco_head(model.infer(dict(tb, image=img))["cls_feats"]), 1)
            return infonce(q, k, model.proj_queue, TEMP)[0].item()

    assert loss_of(tb["image"] + delta) > loss_of(tb["image"])


def test_pgd_vqa_matches_jax():
    cfg = _cfg({"vqa": 1})
    params, _, model, b = _setup(cfg)
    targets = np.random.RandomState(5).rand(3, cfg.vqav2_label_size).astype(np.float32)
    targets[targets < 0.6] = 0
    ref = jax.jit(JP.make_pgd_vqa(ViLTModel(cfg), STEPS, LR, NORM, cfg.vqav2_label_size))(
        params, _j(b), jnp.asarray(targets))
    ours = TP.make_pgd_vqa(model, STEPS, LR, NORM, cfg.vqav2_label_size)(
        _t(b), torch.from_numpy(targets))
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("B", [3, 1])
def test_pgd_irtr_matches_jax(B):
    """B = 1 is the attacked-recall case: negatives-only denominator, so the
    loss is the positive term alone."""
    cfg = _cfg({"itm": 0.5, "irtr_attacked": 1})
    params, _, model, b = _setup(cfg, B=B)
    t = np.random.RandomState(6).randn(B, 128).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    ref = jax.jit(JP.make_pgd_irtr(ViLTModel(cfg), STEPS, LR, NORM, TEMP))(
        params, _j(b), jnp.asarray(t))
    ours = TP.make_pgd_irtr(model, STEPS, LR, NORM, TEMP)(_t(b), torch.from_numpy(t))
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_attack_refuses_other_image_layouts():
    cfg = _cfg({"vqa": 1})
    _, _, model, b = _setup(cfg)
    tb = _t(b)
    attack = TP.make_pgd_vqa(model, 1, LR, NORM, cfg.vqav2_label_size)
    with pytest.raises(ValueError, match="patch rows"):   # flat rows: neither layout
        attack(dict(tb, image=torch.zeros(3, 6 * 768)), torch.zeros(3, 7))
    with pytest.raises(ValueError, match="patch rows"):
        attack(dict(tb, image=torch.zeros(3, 6, 768, dtype=torch.uint8)), torch.zeros(3, 7))
