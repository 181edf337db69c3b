"""The benign-view steps (``augmentation=True``, data/augmentation.py's views
handed in the batch as ``attacked_text_ids`` / ``attacked_text_masks`` and
``augmented_image``) of task_moco and task_barlowtwins through
make_train_step, against the JAX package's step on the CPU in fp32.

tests/test_torch_train.py's task_moco model at one layer and
tests/test_torch_barlowtwins.py's task_barlowtwins model at its two (weights
moved off init; at one layer the head's BatchNorms over 4 rows put the text
LayerNorm's gradient at 1.09 x the bound below, the conditioning that file
describes), the text view
from the batch's swapped ids, the image view a second seeded image; metrics
within rtol 1e-4 (atol 1e-5), MoCo's gradients within 1e-5 x max(1,
max|ref|), BarlowTwins' within 2e-4 x max(1, max|ref|) (that file's reason),
every parameter after AdamW as ``_close_params`` holds it.  The views
themselves are held against the JAX package's in
tests/test_torch_augmentation.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _fake_batch
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
from rmcl_tpu_torch.train import step as TT
from tests.test_attacks import WORDS
from tests.test_torch_barlowtwins import (GRAD_RTOL, SENTENCES, STATS, SWAPPED, _batch,
                                          _trained_like)
from tests.test_torch_barlowtwins import _cfg as bt_cfg
from tests.test_torch_train import _cfg as moco_cfg
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests._torch_threads import one_thread  # noqa: F401


# ------------------------------------------------------------------ steps
def _view(cfg, n, seed):
    """A second seeded image in the batch's layout: the benign image view."""
    return _fake_batch(cfg, n, seed=seed)["image"]


def _step_matches(cfg, params, state, batch, grad_rtol, stats=False):
    """One make_train_step of the port against the JAX package's on the same
    weights and batch (drop_rate 0): metrics, gradients, parameters after
    AdamW (and BarlowTwins' running statistics).  Returns the metrics."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=params,
                                            state=state)
    jgrads = _jflat(jax.jit(jax.grad(lambda p: JT.compute_all_tasks(
        cfg, jmodel, p, jts.state, jbatch, jax.random.PRNGKey(5), train=True)[0]))(
            jts.params))
    jts, jm = JT.make_train_step(cfg, jmodel, tx, donate=False)(jts, jbatch,
                                                                jax.random.PRNGKey(5))
    ts = TT.create_train_state(cfg, model=_port_of(cfg, params, state), device="cpu")
    metrics = TT.make_train_step(cfg, ts)({k: torch.from_numpy(np.array(v))
                                           for k, v in batch.items()},
                                          torch.Generator().manual_seed(0))
    assert set(metrics) == set(jm), set(metrics) ^ set(jm)
    for key, ref in jm.items():
        np.testing.assert_allclose(metrics[key].item(), float(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    for path, g in leaves_to_jax(ts.model, grads=True).items():
        _close(f"grad {path}", g, jgrads[path], grad_rtol)
    want = {**_jflat(jts.params), **_jflat(jts.state)}
    ours = leaves_to_jax(ts.model)
    kept = [p for p in want if p.endswith(STATS)] if stats else []
    for path in kept:
        _close(path, ours[path], want[path], grad_rtol)
    _close_params({p: v for p, v in ours.items() if p not in kept},
                  {p: v for p, v in want.items() if p not in kept},
                  {p: g for p, g in jgrads.items() if not p.startswith("k_")},
                  cfg.learning_rate, "after the step")
    return metrics


def test_benign_moco_step_matches_jax():
    """task_moco with augmentation=True: the text and image views from the
    batch, no PGD, no "both" view (the JAX package drops it too)."""
    cfg = moco_cfg(augmentation=True, num_layers=1)
    params, state = jax.jit(lambda k: init_vilt(k, cfg))(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    batch = _fake_batch(cfg, 4, seed=1, with_views=True)
    batch.pop("text_labels")
    batch["augmented_image"] = _view(cfg, 4, seed=11)
    m = _step_matches(cfg, params, state, batch, 1e-5)
    assert "attacked_txt_loss" in m and "attacked_img_loss" in m
    assert "attacked_both_loss" not in m and "pgd_delta" not in m


def test_benign_barlowtwins_step_matches_jax(tmp_path):
    """task_barlowtwins with augmentation=True: the swapped captions and a
    second image as its views, two views (no "both"), no PGD; the running
    statistics as the JAX step grafts them."""
    tok = JTokenizer(make_tiny_vocab(str(tmp_path / "vocab.txt"), WORDS))
    cfg = bt_cfg(tok.vocab_size, augmentation=True)
    params, state = jax.jit(lambda k: init_vilt(k, cfg))(jax.random.PRNGKey(0))
    batch = _batch(cfg, tok, SENTENCES, SWAPPED)
    batch["augmented_image"] = _view(cfg, len(SENTENCES), seed=11)
    m = _step_matches(cfg, _trained_like(params), state, batch, GRAD_RTOL, stats=True)
    assert {"barlowtwins_loss_invariance_text", "barlowtwins_loss_invariance_img"} <= set(m)
    assert not any("both" in k for k in m) and "pgd_delta" not in m
