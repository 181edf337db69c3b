"""The port's timm loader (``rmcl_tpu_torch/compat/timm.py``) and golden
harness (``rmcl_tpu_torch/compat/golden.py``) against the JAX package's
(``rmcl_tpu/compat/torch_loader.py:load_timm_vit``,
``rmcl_tpu/compat/golden.py``), on the CPU in fp32 at tiny widths, and at the
``vit_small_patch16_224`` preset's own widths (8 heads of D = 96, MLP ratio
3) on a small canvas.

Tolerances.  The timm weights carried into the port equal the JAX package's
converted leaves exactly; a resized pos-embed, the same fp32 weights of
``jax.image.resize``'s bilinear kernel summed in another order, within 1e-6
of max |ref| (``tests/test_torch_load.py:RESIZE_TOL``).  The MLM step's loss:
1e-5 relative (fp32 summation order).  The golden replay: 5e-4, as the JAX
package's own round-trip test holds it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.compat.golden import save_golden as jax_save_golden
from rmcl_tpu.compat.torch_loader import load_timm_vit as jax_load_timm_vit
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.compat import golden as TG
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax, state_dict_from_jax
from rmcl_tpu_torch.compat.timm import load_timm_vit
from rmcl_tpu_torch.core.config import build_config as port_build_config
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.train import step as TT
from tests.conftest import make_fake_batch
from tests.test_compat import _synthetic_timm_sd
from tests.test_torch_convergence import one_thread  # noqa: F401
from tests.test_torch_load import RESIZE_TOL
from tests.test_torch_train import _jflat

STEP_RTOL = 1e-5


def _cfg(losses, **kw):
    """tests/test_compat.py:_cfg's tiny geometry."""
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=8,
        image_size=32, image_bucket_hw=(32, 32), max_text_len=8,
        vocab_size=50, loss_names=loss_names(losses), max_image_len=-1,
        use_pallas_attention=False, compute_dtype="float32", drop_rate=0.0)
    base.update(kw)
    return build_config(**base)


def _port_of(cfg, params, state=None):
    model = ViLT(cfg)
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers, state).items()}) == []
    return model


def _hold_transformer(model, conv, resized=True):
    """The port's transformer leaves against the JAX package's converted
    ones, in the JAX layout: exact, a resized pos-embed within RESIZE_TOL."""
    ours = {k[len("transformer/"):]: v for k, v in leaves_to_jax(model).items()
            if k.startswith("transformer/")}
    want = _jflat(conv)
    assert set(ours) == set(want), set(ours) ^ set(want)
    for path, ref in want.items():
        assert ours[path].shape == ref.shape, path
        if path == "pos_embed" and resized:
            err = np.abs(ours[path] - ref).max()
            assert err <= RESIZE_TOL * np.abs(ref).max(), (path, err)
        else:
            np.testing.assert_array_equal(ours[path], ref, err_msg=path)


# -------------------------------------------------------------------- timm
@pytest.mark.parametrize("layout", ["conv", "linear"])
def test_load_timm_vit_matches_jax(layout):
    """tests/test_compat.py:276's case: a timm dict of grid 7 x 7 (50
    tokens) into the model's 4 x 4, the patch embed in conv or linear
    layout; the same dict through both packages."""
    cfg = _cfg({"itm": 1})
    C, P = cfg.hidden_size, cfg.patch_size
    rng = np.random.RandomState(0)
    sd = _synthetic_timm_sd(cfg, grid=7, rng=rng)
    if layout == "linear":
        sd["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"].reshape(C, 3 * P * P)
    conv = jax_load_timm_vit(dict(sd), cfg)
    ported = load_timm_vit(sd, cfg)
    assert all(k.startswith("transformer.") for k in ported)
    assert ported["transformer.pos_embed"].shape == (1, (32 // 8) ** 2 + 1, C)
    assert ported["transformer.patch_embed.proj.weight"].shape == (C, 3, P, P)

    params, _ = init_vilt(jax.random.PRNGKey(0), cfg)
    model = _port_of(cfg, params)
    skipped = model.load_reference_state_dict(ported)
    assert skipped == []
    _hold_transformer(model, conv)


def test_vit_small_preset_loads_timm_and_steps_like_jax():
    """tests/test_compat.py:602's case: ``vit="vit_small_patch16_224"`` (8
    layers of 768, 8 heads of D = 96, MLP 3 x) on a 96 x 112 canvas; a timm
    dict at the preset's native 14 x 14 grid into both packages; then one
    MLM step of each from the same weights: the loss within 1e-5 relative."""
    kw = dict(vit="vit_small_patch16_224", loss_names=loss_names({"mlm": 1}),
              max_text_len=8, vocab_size=64, max_image_len=16,
              use_pallas_attention=False, compute_dtype="float32",
              drop_rate=0.0, max_steps=10, warmup_steps=0, image_bucket_hw=(96, 112))
    cfg = build_config(**kw)
    pcfg = port_build_config(**{k: v for k, v in kw.items() if k != "use_pallas_attention"})
    assert cfg.num_layers == pcfg.num_layers == 8 and pcfg.mlp_ratio == 3
    assert pcfg.hidden_size // pcfg.num_heads == 96
    sd = _synthetic_timm_sd(cfg, grid=224 // 16, rng=np.random.RandomState(0))
    conv = jax_load_timm_vit(dict(sd), cfg)

    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg)
    model = _port_of(cfg, jax.tree.map(np.asarray, jts.params))
    model.load_reference_state_dict(load_timm_vit(sd, pcfg))
    _hold_transformer(model, conv)
    # AdamW's fresh state depends on the parameters' shapes only
    jts = jts._replace(params=dict(jts.params, transformer=conv))

    b = make_fake_batch(cfg, batch=2)
    labels = np.full(b["text_ids"].shape, -100, np.int32)
    labels[:, 2] = b["text_ids"][:, 2]
    b.update(text_ids_mlm=b["text_ids"], text_labels_mlm=labels)
    jstep = JT.make_train_step(cfg, jmodel, tx, donate=False)
    _, jm = jstep(jts, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
    ts = TT.create_train_state(pcfg, model=model, device="cpu")
    m = TT.make_train_step(pcfg, ts)({k: torch.from_numpy(v) for k, v in b.items()},
                                     torch.Generator().manual_seed(0))
    ref = float(jm["mlm_loss"])
    assert np.isfinite(ref)
    assert abs(m["mlm_loss"].item() - ref) <= STEP_RTOL * abs(ref), (m["mlm_loss"], ref)


# ------------------------------------------------------------------ golden
def test_golden_written_by_jax_replays_through_the_port(tmp_path):
    """A golden file written by the JAX package's ``save_golden`` from its
    ``ViLTModel.infer`` (2 pairs on a 32 x 32 HWC canvas) replays through the
    port's ``compare_golden`` on the weights carried across within 5e-4; the
    same file with ``cls_feats + 1`` raises."""
    cfg = _cfg({"itm": 1}, image_layout="hwc")
    params, _ = init_vilt(jax.random.PRNGKey(3), cfg)
    r = np.random.RandomState(1)
    img = r.uniform(0.1, 1.0, (2, 32, 32, 3)).astype(np.float32)
    ids = r.randint(1, cfg.vocab_size, (2, cfg.max_text_len)).astype(np.int32)
    masks = np.ones_like(ids)
    masks[1, -2:] = 0
    out = ViLTModel(cfg).infer(params, {
        "image": jnp.asarray(img), "text_ids": jnp.asarray(ids),
        "text_masks": jnp.asarray(masks),
        "text_labels": jnp.full_like(jnp.asarray(ids), -100)}, deterministic=True)
    path = str(tmp_path / "golden.npz")
    jax_save_golden(path, {"image": img, "text_ids": ids, "text_masks": masks},
                    {k: np.asarray(out[k]) for k in TG.GOLDEN_KEYS}, meta={"note": "test"})

    model = _port_of(cfg, params)
    errs = TG.compare_golden(path, model, atol=5e-4)
    assert set(errs) == set(TG.GOLDEN_KEYS)
    assert max(errs.values()) < 5e-4

    b, g = TG.load_golden(path)
    g["cls_feats"] = g["cls_feats"] + 1.0
    TG.save_golden(path, b, g)
    with pytest.raises(AssertionError, match="golden mismatch"):
        TG.compare_golden(path, model, atol=5e-4)


# The published checkpoint (reference EVAL.md) and a reference-side dump
# (scripts/make_golden_reference.py); neither is in the repository yet.
# Only the checkout's own models_weight/ is looked in.
_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models_weight", "vilt_200k_mlm_itm.ckpt")
_REAL_CKPT = _CKPT if os.path.isfile(_CKPT) else None


@pytest.mark.skipif(_REAL_CKPT is None,
                    reason="public ViLT checkpoint not mounted in this env")
def test_real_checkpoint_replays_golden():
    """The published vilt_200k_mlm_itm weights through
    ``train/checkpoint.py:load_initial_params`` (``vit32_base`` is a named
    config, not a ``vit=`` preset), then the golden replay at 5e-3 when the
    reference dump is there, else a finite forward."""
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.checkpoint import load_initial_params

    cfg = port_build_config("task_mlm_itm", "vit32_base", image_bucket_hw=(384, 384),
                            max_image_len=-1, compute_dtype="float32", drop_rate=0.0,
                            image_layout="hwc", load_path=_REAL_CKPT)
    model = load_initial_params(cfg, seeded_model(cfg)).eval()
    golden = os.path.join(os.path.dirname(_REAL_CKPT), "golden_vilt_200k.npz")
    if os.path.isfile(golden):
        errs = TG.compare_golden(golden, model, atol=5e-3)
        print("golden parity:", errs)
        return
    r = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(r.uniform(-1, 1, (1, 384, 384, 3)).astype(np.float32)),
             "text_ids": torch.from_numpy(r.randint(1000, 2000, (1, 40)).astype(np.int32)),
             "text_masks": torch.ones(1, 40, dtype=torch.int32)}
    with torch.no_grad():
        out = model.infer(batch)
    assert torch.isfinite(out["cls_feats"]).all()
