"""The port's model (rmcl_tpu_torch/models) against the JAX package on the
same weights and inputs, on CPU in fp32: the state-dict conversion, each
embedding and head, and the whole deterministic forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _fake_batch
from rmcl_tpu.compat.torch_loader import export_state_dict
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.models import heads as JH
from rmcl_tpu.models.text_embeddings import text_embeddings as jax_text_embeddings
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.models.vit import (_normalize_u8, scatter_delta as jax_scatter_delta,
                                 visual_embed, visual_embed_from_prep,
                                 visual_embed_prepare)
from rmcl_tpu_torch.compat.from_jax import state_dict_from_jax
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.models.vit import normalize_u8, scatter_delta
from tests._torch_threads import one_thread  # noqa: F401

ATOL = 2e-4      # as tests/test_compat.py holds the converted forward
TASK_LOSS = {"mlm": {"mlm": 1}, "itm": {"itm": 1}, "rank": {"irtr": 1},
             "vqa": {"vqa": 1}, "embed": {"moco": 1}}


def _cfg(losses, **kw):
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=16,
        image_size=32, image_bucket_hw=(32, 48), max_text_len=10,
        vocab_size=64, loss_names=loss_names(losses),
        use_pallas_attention=False, compute_dtype="float32",
        drop_rate=0.0, vqav2_label_size=7, image_dtype="uint8")
    base.update(kw)
    return build_config(**base)


def _pair(cfg, seed=0):
    """(JAX params, the port loaded with the same weights and state)."""
    params, state = init_vilt(jax.random.PRNGKey(seed), cfg)
    model = ViLT(cfg)
    sd = {k: torch.from_numpy(v)
          for k, v in state_dict_from_jax(params, cfg.num_layers, state).items()}
    assert model.load_reference_state_dict(sd) == []
    return params, model


def _batch(cfg, B=3, seed=0):
    b = _fake_batch(cfg, B, seed=seed, image_dtype="uint8")
    return {k: b[k] for k in ("image", "image_hw", "text_ids", "text_masks")}


@pytest.mark.parametrize("task", sorted(TASK_LOSS))
def test_state_dict_from_jax_matches_export(task):
    cfg = _cfg(TASK_LOSS[task])
    params, state = init_vilt(jax.random.PRNGKey(1), cfg)
    ref = export_state_dict(params, state, cfg.num_layers)
    ours = state_dict_from_jax(params, cfg.num_layers, state)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if task == "embed":   # the momentum twins and the queue come across too
        assert "proj_queue" in ours and any(k.startswith("k_transformer.") for k in ours)
    model = ViLT(cfg)
    skipped = model.load_reference_state_dict(
        {k: torch.from_numpy(v) for k, v in ours.items()})
    assert skipped == []
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ours.items()},
                          strict=True)


def test_text_embeddings_match():
    cfg = _cfg({"vqa": 1})
    params, model = _pair(cfg)
    ids = _batch(cfg)["text_ids"]
    ref = jax_text_embeddings(params["text_embeddings"], jnp.asarray(ids))
    ours = model.text_embeddings(torch.from_numpy(ids), torch.float32)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("max_image_len", [-1, 4])
def test_visual_embed_u8_matches(max_image_len):
    """u8 rows with partial image_hw; max_image_len=4 < N=6 runs the
    stable-sort patch selection."""
    cfg = _cfg({"vqa": 1}, max_image_len=max_image_len)
    params, model = _pair(cfg)
    b = _batch(cfg, B=4, seed=3)
    b["image_hw"][0] = (16, 16)          # one sample with a single valid patch
    img_j = _normalize_u8(jnp.asarray(b["image"]), jnp.asarray(b["image_hw"]),
                          cfg.grid_hw, cfg.patch_size)
    img_t = normalize_u8(torch.from_numpy(b["image"]), torch.from_numpy(b["image_hw"]),
                         cfg.grid_hw, cfg.patch_size)
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))

    spec = ViLTModel(cfg).spec
    x_j, m_j, _, _ = visual_embed(params["transformer"], img_j, spec=spec,
                                  max_image_len=max_image_len, dtype=jnp.float32,
                                  grid_hw=cfg.grid_hw)
    x_t, m_t = model.transformer.visual_embed(img_t, cfg.grid_hw, max_image_len,
                                              torch.float32)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(x_t.detach().numpy(), np.asarray(x_j), atol=1e-5)


@pytest.mark.parametrize("head", ["pooler", "itm_score", "mlm_score",
                                  "vqa_classifier", "rank_output", "moco_head"])
def test_heads_match(head):
    cfg = _cfg({"mlm": 1, "irtr": 1, "vqa": 1, "moco": 1})
    params, model = _pair(cfg)
    x = np.random.RandomState(5).randn(3, 4, cfg.hidden_size).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref, ours = {
        "pooler": lambda: (JH.pooler(params["pooler"], xj), model.pooler(xt)),
        "itm_score": lambda: (JH.itm_head(params["itm_score"], xj),
                              model.itm_score(xt)),
        "mlm_score": lambda: (JH.mlm_head(params["mlm_score"], xj),
                              model.mlm_score(xt)),
        "vqa_classifier": lambda: (JH.vqa_classifier(params["vqa_classifier"], xj),
                                   model.vqa_classifier(xt)),
        "rank_output": lambda: (JH.rank_output(params["rank_output"], xj),
                                model.rank_output(xt)),
        "moco_head": lambda: (JH.moco_head(params["moco_head"], xj),
                              model.moco_head(xt)),
    }[head]()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("jax_impl", ["default", "fused"])
def test_infer_matches_jax(jax_impl, monkeypatch):
    """The whole forward vs JAX's default (XLA) blocks and vs its fused
    Pallas half-block kernels in interpret mode, with patch selection."""
    monkeypatch.setenv("RMCL_PALLAS_INTERPRET", "1")
    impl = {} if jax_impl == "default" else dict(attention_impl="fused",
                                                 mlp_impl="fused")
    cfg = _cfg({"vqa": 1}, max_image_len=5, **impl)
    params, model = _pair(cfg, seed=2)
    b = _batch(cfg, B=3, seed=4)
    ref = ViLTModel(cfg).infer(params, {k: jnp.asarray(v) for k, v in b.items()},
                               deterministic=True)
    with torch.inference_mode():
        ours = model.infer({k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("text_feats", "image_feats", "cls_feats", "image_masks"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


def test_momentum_twins_and_queue_load_and_init():
    """The k_* twins and the queue state come across from JAX; a state dict
    without the queue leaves the model's own; a seeded init makes the twins
    exact copies and the queue random."""
    cfg = _cfg({"moco": 1}, num_negative=16)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    model = ViLT(cfg)
    sd = state_dict_from_jax(params, cfg.num_layers, state)
    model.load_reference_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert model.proj_queue.shape == (128, 16) and model.proj_queue.dtype == torch.float32
    np.testing.assert_array_equal(model.proj_queue.numpy(), np.asarray(state["proj_queue"]))
    np.testing.assert_array_equal(
        model.k_transformer.blocks[1].attn["qkv"].weight.detach().numpy(),
        np.asarray(params["k_transformer"]["blocks"]["attn"]["qkv"]["kernel"][1]).T)
    before = model.proj_queue.clone()
    no_queue = {k: torch.from_numpy(v) for k, v in sd.items() if not k.startswith("proj_")}
    assert model.load_reference_state_dict(no_queue) == []
    assert torch.equal(model.proj_queue, before)

    fresh = ViLT(cfg).init(torch.Generator().manual_seed(0))
    for a, b in zip(fresh.transformer.parameters(), fresh.k_transformer.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(fresh.moco_head.projector["3"].weight,
                       fresh.k_moco_head.projector["3"].weight)
    assert 0.5 < fresh.proj_queue.std().item() < 1.5
    assert not hasattr(ViLT(_cfg({"vqa": 1})), "k_transformer")


def test_infer_k_matches_jax():
    """The key path: momentum twins (made to differ from the query side) and
    the shared pooler, against ``ViLTModel.infer_k``."""
    cfg = _cfg({"moco": 1}, num_negative=16, max_image_len=5)
    params, _ = init_vilt(jax.random.PRNGKey(3), cfg)
    r = np.random.RandomState(0)
    params = dict(params)
    for name in ("k_text_embeddings", "k_token_type_embeddings", "k_transformer",
                 "k_moco_head"):
        params[name] = jax.tree.map(
            lambda a: a + jnp.asarray(0.02 * r.randn(*a.shape), a.dtype), params[name])
    model = ViLT(cfg)
    model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers).items()})
    b = _batch(cfg, B=3, seed=6)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jm = ViLTModel(cfg)
    ref_k = jm.infer_k(params, jb, deterministic=True)
    ref_q = jm.infer(params, jb, deterministic=True)
    with torch.inference_mode():
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        ours_k, ours_q = model.infer_k(tb), model.infer(tb)
        z = model.k_moco_head(ours_k["cls_feats"])
    for k in ("text_feats", "image_feats", "cls_feats"):
        np.testing.assert_allclose(ours_k[k].numpy(), np.asarray(ref_k[k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(ours_q["cls_feats"].numpy(), np.asarray(ref_q["cls_feats"]),
                               atol=ATOL)
    assert np.abs(np.asarray(ref_k["cls_feats"]) - np.asarray(ref_q["cls_feats"])).max() > 1e-3
    np.testing.assert_allclose(
        z.numpy(), np.asarray(JH.moco_head(params["k_moco_head"], ref_k["cls_feats"])),
        atol=ATOL)


@pytest.mark.parametrize("max_image_len", [-1, 4])
def test_visual_embed_from_prep_matches(max_image_len):
    """The hoisted geometry (prepare once, embed rows + delta) and
    scatter_delta against the JAX package, and ``infer`` fed the prepared
    embeddings against ``infer`` that embeds the perturbed image itself."""
    cfg = _cfg({"vqa": 1}, max_image_len=max_image_len, image_dtype="float32")
    params, model = _pair(cfg)
    b = _batch(cfg, B=3, seed=3)
    img = np.asarray(_normalize_u8(jnp.asarray(b["image"]), jnp.asarray(b["image_hw"]),
                                   cfg.grid_hw, cfg.patch_size))
    spec = ViLTModel(cfg).spec
    tr = params["transformer"]
    prep_j = visual_embed_prepare(tr, jnp.asarray(img), spec=spec,
                                  max_image_len=max_image_len, grid_hw=cfg.grid_hw)
    prep_t = model.transformer.visual_embed_prepare(torch.from_numpy(img.copy()),
                                                    cfg.grid_hw, max_image_len)
    assert prep_t.n_patches == prep_j.n_patches
    np.testing.assert_array_equal(prep_t.rows_sel.numpy(), np.asarray(prep_j.rows_sel))
    np.testing.assert_array_equal(prep_t.x_mask.numpy(), np.asarray(prep_j.x_mask))
    np.testing.assert_allclose(prep_t.pos_full.detach().numpy(), np.asarray(prep_j.pos_full),
                               atol=1e-6)
    if max_image_len > 0:
        np.testing.assert_array_equal(prep_t.sel.numpy(), np.asarray(prep_j.sel))
    else:
        assert prep_t.sel is None and prep_j.sel is None

    # zero on padding patches, as a PGD perturbation is: the geometry is then invariant
    delta = (0.01 * np.random.RandomState(1).randn(*prep_t.rows_sel.shape)).astype(np.float32)
    delta *= prep_t.x_mask[:, 1:, None].numpy()
    x_j, m_j = visual_embed_from_prep(tr, prep_j, jnp.asarray(delta), spec=spec,
                                      dtype=jnp.float32)
    with torch.inference_mode():
        x_t, m_t = model.transformer.visual_embed_from_prep(
            prep_t, torch.from_numpy(delta), torch.float32)
        full_t = scatter_delta(prep_t, torch.from_numpy(delta))
        tb = {"text_ids": torch.from_numpy(b["text_ids"]),
              "text_masks": torch.from_numpy(b["text_masks"])}
        fed = model.infer(tb, image_embeds=x_t, image_masks=m_t)
        own = model.infer(dict(tb, image=torch.from_numpy(img.copy()) + full_t))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-5)
    np.testing.assert_array_equal(full_t.numpy(),
                                  np.asarray(jax_scatter_delta(prep_j, jnp.asarray(delta))))
    np.testing.assert_allclose(fed["cls_feats"].numpy(), own["cls_feats"].numpy(), atol=1e-5)
