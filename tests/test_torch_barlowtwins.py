"""The port's BarlowTwins framework (models/layers.py:batch_norm, BatchNorm1d,
models/heads.py:BarlowTwinsHead, objectives/contrastive.py:bt_correlation_loss,
compute_barlowtwins_contrastive, attacks/pgd.py:make_pgd_barlowtwins,
attacks/greedy.py:GreedyAttackBarlowTwins, the task_barlowtwins step, the
attacked step, accumulation, the parameter groups, the Trainer and the CLI)
against the JAX package on the CPU in fp32: 2 layers, C = 32, 2 heads,
bt_proj_dims (64, 64, 64) ((8, 8, 8) for the B >= D branch), max_text_len 12,
n_candidates 3, max_loops 2, drop_rate 0, the vocabulary and counter-fitted
vectors of tests/test_attacks.py, weights carried by compat/from_jax.py.

Conditioning.  In training mode the head's BatchNorms divide each feature by
its spread over the batch, so an fp32 rounding difference in the encoder's
output (~3e-7) comes out of the head multiplied by |feature| / spread.  At
initialisation every caption starts with [CLS] and a 2-layer model at std
0.02 gives all rows nearly the same class feature, a spread of ~1e-5 of the
feature: both packages then compute the head from rounding noise.  The
weights here are moved off their initial values (``_trained_like``: + 0.1 x
N(0, 1) on every leaf, as a trained model's are), which brings the spread to
~1e-3; the worst gradient then differs from the JAX package's by 1.2e-4 of
its tensor's max (larger moves of the weights did not lower it: with 4 rows
some feature always has a small spread).  So gradients and running
statistics are held to GRAD_RTOL = 2e-4 x max(1, max|ref|), the bound of
chip_smoke.py's fp32 card-against-CPU steps, not the MoCo step's 1e-5; the
view losses and diagnostics of a step to rtol 1e-4 (the MoCo step's metric
tolerance), the evaluation's to 1e-5; the parameters after AdamW as
``_close_params`` holds the MoCo step's; PGD's delta to adv_lr_img x
GRAD_RTOL (each step moves an element by adv_lr_img x g / max|g|); token
ids and change counts exactly.

The JAX package's programs are compiled once in the module fixture ``j`` and
shared; the port runs eagerly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import greedy_fused as JF
from rmcl_tpu.attacks import pgd as JP
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models import heads as JH
from rmcl_tpu.models import layers as JLayers
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.objectives import contrastive as JC
from rmcl_tpu.train import loop as JL
from rmcl_tpu.train import schedule as JS
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.attacks import greedy as TG
from rmcl_tpu_torch.attacks import greedy_fused as TF
from rmcl_tpu_torch.attacks.pgd import make_pgd_barlowtwins
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax, state_dict_from_jax
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.models.heads import BarlowTwinsHead
from rmcl_tpu_torch.models.layers import BatchNorm1d, batch_norm
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.objectives import contrastive as TC
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.train import loop as TL
from rmcl_tpu_torch.train import schedule as TS
from rmcl_tpu_torch.train import step as TT
from tests.conftest import make_fake_batch
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_greedy import _write_vectors
from tests.test_torch_train import _close, _close_params, _jax_path, _jflat, _port_of
from tests._torch_threads import one_thread  # noqa: F401

GRAD_RTOL = 2e-4
SENTENCES = ["dog runs in park", "cat sits in street", "big red car on road", "the a on in"]
# the captions with words swapped for synonyms: the text view of the steps
# whose attacked ids come in the batch
SWAPPED = ["puppy runs in garden", "kitten sits in road", "large crimson auto on street",
           "the a on in"]
STATS = ("running_mean", "running_var")


def _cfg(vocab_size, **kw):
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=16, image_size=32,
        image_bucket_hw=(32, 48), max_text_len=12, vocab_size=vocab_size,
        loss_names=loss_names({"barlowtwins": 1}), bt_proj_dims=(64, 64, 64),
        use_pallas_attention=False, compute_dtype="float32", drop_rate=0.0, max_image_len=4,
        image_view=True, text_view=True, adv_steps_img=2, adv_lr_img=0.05,
        adv_max_norm_img=0.005, adv_lr=0.0051, learning_rate=1e-3, weight_decay=0.01,
        lr_mult=10, max_steps=100, warmup_steps=0, n_candidates=3, max_loops=2)
    base.update(kw)
    return build_config(**base)


def _trained_like(params, seed=3, scale=0.1):
    """Every leaf moved off its initial value by scale x N(0, 1) (a running
    variance multiplied by exp of that), so that the class features differ
    across a batch as a trained model's do (the module docstring)."""
    r = np.random.RandomState(seed)

    def move(path, a):
        noise = scale * r.randn(*np.shape(a))
        if path[-1].key == "running_var":
            return jnp.asarray(np.asarray(a) * np.exp(noise), a.dtype)
        return jnp.asarray(np.asarray(a) + noise, a.dtype)

    return jax.tree_util.tree_map_with_path(move, params)


def _batch(cfg, tok, sentences, swapped=None, seed=0):
    ids, masks = tok.batch_encode(sentences, cfg.max_text_len)
    img = make_fake_batch(cfg, batch=len(sentences), seed=seed)["image"]
    out = {"image": hwc_to_patch_rows(img, cfg.patch_size),
           "text_ids": ids.astype(np.int32), "text_masks": masks.astype(np.int32)}
    if swapped is not None:
        a_ids, a_masks = tok.batch_encode(swapped, cfg.max_text_len)
        out.update(attacked_text_ids=a_ids.astype(np.int32),
                   attacked_text_masks=a_masks.astype(np.int32))
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _stats(flat):
    return {p: v for p, v in flat.items() if p.endswith(STATS)}


class J:
    """The JAX side, made once per module (the ``j`` fixture)."""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bt")
    return (make_tiny_vocab(str(d / "vocab.txt"), WORDS),
            _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS))


@pytest.fixture(scope="module")
def j(files):
    """The JAX package's tokenizer, synonyms, model, weights and programs:
    the attacker extras, the host attack on them (whose ids also feed the
    gradient of the attacked step), the gradient of the task, the step, the
    attacked step; each compiled once."""
    vocab, vectors = files
    j = J()
    j.files = files
    j.tok = JTokenizer(vocab)
    j.syn = JG.SynonymTable(vectors, 3, 0.5)
    j.cfg = cfg = _cfg(j.tok.vocab_size)
    j.model = ViLTModel(cfg)
    params, j.state = init_vilt(jax.random.PRNGKey(0), cfg)
    j.params = _trained_like(params)
    j.batch = _batch(cfg, j.tok, SENTENCES, SWAPPED)
    clean = {k: v for k, v in j.batch.items() if not k.startswith("attacked_")}
    j.extras = jax.jit(lambda p, s, b: JL.greedy_attack_extras(
        cfg, j.model, "barlowtwins", p, s, b))(j.params, j.state, _j(clean))
    j.host = JG.GreedyAttackBarlowTwins(cfg, j.model, j.tok, j.syn)
    j.attacked = j.host.adv_attack_samples(j.params, clean, j.extras)
    j.grad = jax.jit(jax.grad(lambda p, s, b: JT.compute_all_tasks(
        cfg, j.model, p, s, b, jax.random.PRNGKey(7), train=True)[0]))
    _, j.ts, j.tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=j.params,
                                          state=j.state)
    return j


def _port(j, cfg=None):
    cfg = cfg or j.cfg
    return TT.create_train_state(cfg, model=_port_of(cfg, j.params, j.state), device="cpu")


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(training, affine):
    """batch_norm and BatchNorm1d against layers.batch_norm: the output and
    the new statistics within 1e-6 (biased variance in the output, the
    unbiased one in the running update); the module writes its buffers only
    when training and asked to."""
    r = np.random.RandomState(0)
    x = (2.0 * r.randn(6, 16) + 0.5).astype(np.float32)
    p = JLayers.batch_norm_init(16, affine)
    p = {k: (v + 0.3 * r.randn(16)).astype(np.float32) if k != "running_var"
         else np.exp(0.3 * r.randn(16)).astype(np.float32) for k, v in p.items()}
    y_ref, st_ref = JLayers.batch_norm(_j(p), jnp.asarray(x), training)
    tp = _t(p)
    y, mean, var = batch_norm(torch.from_numpy(x), tp["running_mean"], tp["running_var"],
                              tp.get("weight"), tp.get("bias"), training)
    _close("y", y, y_ref, 1e-6)
    _close("new mean", mean, st_ref["running_mean"], 1e-6)
    _close("new var", var, st_ref["running_var"], 1e-6)
    bn = BatchNorm1d(16, affine)
    bn.load_state_dict(tp)
    for update in (False, True):
        _close("module y", bn(torch.from_numpy(x), training, update), y_ref, 1e-6)
        moved = not torch.equal(bn.running_mean, tp["running_mean"])
        assert moved == (training and update)
    assert y.dtype == torch.float32
    yb = batch_norm(torch.from_numpy(x).bfloat16(), tp["running_mean"], tp["running_var"],
                    tp.get("weight"), tp.get("bias"), training)[0]
    assert yb.dtype == torch.bfloat16                    # fp32 inside, cast back


# ------------------------------------------------------ correlation loss
@pytest.mark.parametrize("B,D", [(6, 16), (20, 8)], ids=["gram", "explicit"])
def test_bt_correlation_loss_matches_jax(B, D):
    """Both branches (the (B, B) Gram form when B < D, the (D, D) matrix
    when B >= D): (loss, on, lam * off) and the gradient with respect to q
    within 1e-5 relative; the two forms agree with each other."""
    r = np.random.RandomState(B)
    q, k = r.randn(B, D).astype(np.float32), r.randn(B, D).astype(np.float32)
    ref = JC.bt_correlation_loss(jnp.asarray(q), jnp.asarray(k), B, 0.0051)
    g_ref = jax.grad(lambda a: JC.bt_correlation_loss(a, jnp.asarray(k), B, 0.0051)[0])(
        jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    ours = TC.bt_correlation_loss(qt, torch.from_numpy(k), B, 0.0051)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    g, = torch.autograd.grad(ours[0], qt)
    _close("dL/dq", g, g_ref)
    # the other branch's algebra on the same inputs: the explicit matrix
    c = q.astype(np.float64).T @ k.astype(np.float64) / B
    off = (c ** 2).sum() - (np.diagonal(c) ** 2).sum()
    np.testing.assert_allclose(ours[2].item(), 0.0051 * off, rtol=1e-4)


def test_head_matches_jax():
    """BarlowTwinsHead against heads.barlowtwins_head on the same weights
    (reference names projector.{0,1,3,4,6} and norm): the output in training
    and eval mode, the input gradient in training mode, and the three
    chained statistics of a training call; eval mode moves nothing."""
    r = np.random.RandomState(1)
    p = _trained_like(JH.init_barlowtwins_head(jax.random.PRNGKey(2), 32, [64, 64], 64))
    head = BarlowTwinsHead(32, (64, 64), 64)
    sd = {k[len("h."):]: torch.from_numpy(v)
          for k, v in state_dict_from_jax({"h": p}, 0).items()}
    head.load_state_dict(sd)
    assert sorted(sd) == sorted(head.state_dict())
    x = r.randn(8, 32).astype(np.float32)
    for training in (False, True):
        ref, st = JH.barlowtwins_head(p, jnp.asarray(x), training)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = head(xt, training, update=training)
        _close(f"z training={training}", y, ref)
        if training:
            g_ref = jax.grad(lambda a: jnp.sum(JH.barlowtwins_head(p, a, True)[0] ** 3))(
                jnp.asarray(x))
            g, = torch.autograd.grad((y ** 3).sum(), xt)
            _close("dz/dx", g, g_ref)
            ours = {k: v for k, v in leaves_to_jax(head).items() if k.endswith(STATS)}
            assert len(ours) == 6
            for path, a in ours.items():
                _close(path, a, _jflat(st)[path])
        else:
            for path, a in leaves_to_jax(head).items():
                if path.endswith(STATS):
                    _close(path, a, _jflat(st)[path], 0.0)


# ------------------------------------------------------------- objective
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_compute_barlowtwins_contrastive_matches_jax(j, train):
    """compute_barlowtwins_contrastive with the text view from the batch and
    the image view from 2-step PGD against the JAX package's: every key of
    ret within rtol 1e-4 (train) or 1e-5 (eval; atol 1e-6), and the running
    statistics chained through key, text, image and both (train) or
    untouched (eval)."""
    cfg = j.cfg
    pgd = JP.make_pgd_barlowtwins(j.model, cfg.adv_steps_img, cfg.adv_lr_img,
                                  cfg.adv_max_norm_img, cfg.adv_lr)

    @jax.jit
    def ref_fn(p, s, b):
        return JC.compute_barlowtwins_contrastive(
            j.model, p, s, b, rng=jax.random.PRNGKey(7), train=train, text_view=True,
            image_view=True, attacked_text={"text_ids": b["attacked_text_ids"],
                                            "text_masks": b["attacked_text_masks"]},
            pgd_fn=pgd, adv_lr=cfg.adv_lr, per_step_bs=b["text_ids"].shape[0])

    ret_ref, _, state_ref = ref_fn(j.params, j.state, _j(j.batch))
    ts = _port(j)
    model = ts.model
    tb = _t(j.batch)
    attack = make_pgd_barlowtwins(model, cfg.adv_steps_img, cfg.adv_lr_img,
                                  cfg.adv_max_norm_img, cfg.adv_lr)
    ctx = torch.enable_grad() if train else torch.no_grad()
    with ctx:
        ret = TC.compute_barlowtwins_contrastive(
            model, tb, seeds=torch.zeros(4, 3, 2, 4, dtype=torch.int32), train=train,
            text_view=True, image_view=True,
            attacked_text={"text_ids": tb["attacked_text_ids"],
                           "text_masks": tb["attacked_text_masks"]},
            pgd_fn=lambda b, k: attack(b, k), adv_lr=cfg.adv_lr)
    assert set(ret) == set(ret_ref) and len(ret) == 16, set(ret) ^ set(ret_ref)
    for key, ref in ret_ref.items():
        np.testing.assert_allclose(ret[key].item(), float(ref), rtol=1e-4 if train else 1e-5,
                                   atol=1e-6, err_msg=key)
    assert ret["barlowtwins_loss"].requires_grad == train
    ours = _stats(leaves_to_jax(model))
    want = (_jflat({"barlowtwins_head": state_ref["bt_bn_stats"]}) if train
            else _stats(_jflat(j.params)))
    assert set(ours) == set(want) and len(want) == 6
    for path, ref in want.items():
        _close(path, ours[path], ref, GRAD_RTOL if train else 0.0)
    if train:        # four chained updates moved every statistic
        before = _stats(_jflat(j.params))
        assert all(np.abs(ours[p] - before[p]).min() > 0 for p in before)


def test_pgd_barlowtwins_matches_jax(j):
    """make_pgd_barlowtwins (2 steps, the fast path) against the JAX
    package's from the keys of its attacker extras: delta within
    adv_lr_img x GRAD_RTOL (the module docstring), the running statistics
    untouched, the parameters' requires_grad restored."""
    cfg = j.cfg
    clean = _j({k: v for k, v in j.batch.items() if not k.startswith("attacked_")})
    ref = jax.jit(JP.make_pgd_barlowtwins(j.model, cfg.adv_steps_img, cfg.adv_lr_img,
                                          cfg.adv_max_norm_img, cfg.adv_lr))(
        j.params, clean, j.extras[0])
    ts = _port(j)
    before = leaves_to_jax(ts.model)
    attack = make_pgd_barlowtwins(ts.model, cfg.adv_steps_img, cfg.adv_lr_img,
                                  cfg.adv_max_norm_img, cfg.adv_lr)
    delta = attack(_t(j.batch), torch.from_numpy(np.array(j.extras[0])))
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref), atol=cfg.adv_lr_img * GRAD_RTOL,
                               rtol=0)
    assert np.abs(np.asarray(ref)).max() > 1e-3
    after = leaves_to_jax(ts.model)
    assert all(np.array_equal(after[p], before[p]) for p in before)
    assert all(p.requires_grad for p in ts.model.parameters())


# ---------------------------------------------------------------- greedy
def _port_attack(j, model, fused: bool, **kw):
    vocab, vectors = j.files
    cfg = j.cfg.replace(**kw)
    base = TG.GreedyAttackBarlowTwins(cfg, model, WordPieceTokenizer(vocab),
                                      TG.SynonymTable(vectors, 3, 0.5))
    return TF.FusedGreedyAttack(base) if fused else base


def _same(ours, ref, what):
    np.testing.assert_array_equal(ours["txt_input_ids"], ref["txt_input_ids"], err_msg=what)
    np.testing.assert_array_equal(ours["text_masks"], ref["text_masks"], err_msg=what)
    assert ours["changes_verification"] == ref["changes_verification"], what
    assert abs(ours["change_rate"] - ref["change_rate"]) < 1e-9, what


def _port_extras(j):
    k, psb, lam = j.extras
    return torch.from_numpy(np.array(k)), int(psb), float(lam)


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_greedy_attack_matches_jax(j, fused):
    """GreedyAttackBarlowTwins, host and fused, with greedy_compact_frac 0.5
    and greedy_score_max_rows 4 set (neither applies: the correlation loss
    couples the batch), against the JAX package's host attack on the same
    weights and extras: token ids, masks and change counts equal; the fused
    attack scores all B * nc rows in one forward per loop and launches no
    kernel on the CPU; the running statistics untouched."""
    ts = _port(j)
    before = _stats(leaves_to_jax(ts.model))
    att = _port_attack(j, ts.model, fused, greedy_compact_frac=0.5, greedy_score_max_rows=4)
    assert att.base.score_chunk(4, 3) == 3 if fused else att.score_chunk(4, 3) == 3
    clean = _t({k: v for k, v in j.batch.items() if not k.startswith("attacked_")})
    FB.reset_launches()
    ours = att.adv_attack_samples(clean, _port_extras(j))
    assert FB.launches == dict.fromkeys(FB.launches, 0)
    _same(ours, j.attacked, "fused" if fused else "host")
    assert sum(j.attacked["changes_verification"]) > 0
    if fused:
        s = att.last_stats
        assert s["score_forwards"] == s["loops"] >= 1 and s["host_reads"] == s["loops"] + 1
    after = _stats(leaves_to_jax(ts.model))
    assert all(np.array_equal(after[p], before[p]) for p in before)


@pytest.mark.parametrize("dims,B", [((64, 64, 64), 4), ((8, 8, 8), 8)], ids=["gram", "explicit"])
def test_score_candidates_matches_jax(j, dims, B):
    """score_candidates in both branches (B < D by the cross-Gram, B >= D by
    the explicit c) against the JAX package's on the same candidate rows,
    aux and keys (rtol 1e-4: scores of the order of the loss, the head
    conditioned as the module docstring says), and against the loss itself
    recomputed with row i's projection replaced by the candidate's (the
    rank-1 update is exact)."""
    cfg = j.cfg.replace(bt_proj_dims=dims)
    params, state = init_vilt(jax.random.PRNGKey(1), cfg)
    params = _trained_like(params, seed=5)
    jmodel = ViLTModel(cfg)
    nc = 2
    r = np.random.RandomState(B)
    sents = [" ".join(r.choice(WORDS, 4)) for _ in range(B)]
    batch = _batch(cfg, j.tok, sents, seed=1)
    cands = [" ".join(r.choice(WORDS, 4)) for _ in range(B * nc)]
    cids, cmasks = j.tok.batch_encode(cands, cfg.max_text_len)
    jbase = JG.GreedyAttackBarlowTwins(cfg, jmodel, j.tok, j.syn)
    D = dims[2]
    k = r.randn(B, D).astype(np.float32)
    extras = (jnp.asarray(k), B, cfg.adv_lr)

    def ref_fn(p, b, ci, cm):
        _, q = jbase.loss_per_sample(p, b, extras)
        flat = dict(b, image=jnp.repeat(b["image"], nc, 0), text_ids=ci, text_masks=cm)
        return q, jbase.score_candidates(p, flat, B, nc, extras, q)

    q_ref, s_ref = jax.jit(ref_fn)(params, _j(batch), jnp.asarray(cids), jnp.asarray(cmasks))
    model = _port_of(cfg, params, state)
    base = TG.GreedyAttackBarlowTwins(cfg, model, WordPieceTokenizer(j.files[0]), None)
    tb = _t(batch)
    side = base.image_side(tb)
    mats = base.matrices()
    with torch.no_grad():
        _, q = base.loss_per_sample(dict(side, **tb), (torch.from_numpy(k), B, cfg.adv_lr), mats)
        scores = base.score_pass(dict(side, **tb),
                                 torch.from_numpy(cids.reshape(B, nc, -1)).int(),
                                 torch.from_numpy(cmasks.reshape(B, nc, -1)).int(),
                                 (torch.from_numpy(k), B, cfg.adv_lr), q, mats)
        _close("q of the gradient pass", q, q_ref, GRAD_RTOL)
        np.testing.assert_allclose(scores.numpy(), np.asarray(s_ref), rtol=1e-4)
        # the rank-1 update against the loss recomputed with the row replaced
        flat = {key: v.repeat_interleave(nc, 0) for key, v in side.items()}
        flat.update(text_ids=torch.from_numpy(cids).int(),
                    text_masks=torch.from_numpy(cmasks).int())
        q_cand = model.barlowtwins_head(base.infer(flat, mats)["cls_feats"], training=True)
        for i, jj in ((0, 0), (B - 1, nc - 1)):
            q_sub = q.clone()
            q_sub[i] = q_cand[i * nc + jj]
            full = TC.bt_correlation_loss(q_sub, torch.from_numpy(k), B, cfg.adv_lr)[0]
            np.testing.assert_allclose(scores[i, jj].item(), full.item(), rtol=1e-5)


# ------------------------------------------------------------- the steps
def _jax_state_flat(jts):
    return {**_jflat(jts.params), **_jflat(jts.state)}


def _restart_from_jax(ts, cfg, jts):
    """The port's parameters, running statistics and AdamW moments set to the
    JAX package's after the same step (its step count and schedule already
    match), so that the next step of each starts from one state."""
    import optax
    model = ts.model
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in state_dict_from_jax(jts.params, cfg.num_layers, jts.state).items()}) == []
    ts.refresh_block_matrices()
    adam = [s for s in jax.tree_util.tree_leaves(
        jts.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        trees = [s.mu if key == "exp_avg" else s.nu for s in adam]
        # a leaf no AdamW group holds (the running statistics) keeps zeros
        full = jax.tree.map(lambda p, *xs: next((x for x in xs if not masked(x)),
                                                jnp.zeros_like(p)), jts.params, *trees)
        moments[key] = dict(_port_of(cfg, full, jts.state).named_parameters())
    n = 0
    for name, p in model.named_parameters():
        st = ts.optimizer.state[p]
        assert int(st["step"]) == int(jts.step)
        for key, got in moments.items():
            st[key].copy_(got[name].detach())
        n += 1
    assert n == len(ts.optimizer.state)


def test_two_steps_match_jax(j):
    """Two task_barlowtwins steps (text view from the batch's swapped
    captions, image view from 2-step PGD) against make_train_step on the
    same weights and batch: every metric (rtol 1e-4, atol 1e-5), total_loss
    and lr; the gradient of every parameter (GRAD_RTOL); after each step
    every parameter (``_close_params``, its firm elements those of the JAX
    package's gradient of that step) and the six running statistics chained
    through the step's four head calls (GRAD_RTOL; they moved).  The second
    step starts on both sides from the JAX package's state after the first
    (parameters, statistics, AdamW moments): from parameters that differ
    within the first step's bounds the head's BatchNorms move the gradients
    by more than AdamW's 2% window."""
    cfg = j.cfg
    jstep = JT.make_train_step(cfg, j.model, j.tx, donate=False)
    jbatch = _j(j.batch)
    jts = j.ts
    ts = _port(j)
    step = TT.make_train_step(cfg, ts)
    gen = torch.Generator().manual_seed(0)
    init = _stats(_jflat(j.params))
    for it in range(2):
        if it == 1:
            _restart_from_jax(ts, cfg, jts)
        # drop_rate 0: the step draws nothing from its key, so j.grad's is the step's
        jgrads = _jflat(j.grad(jts.params, jts.state, jbatch))
        jts, jm = jstep(jts, jbatch, jax.random.PRNGKey(7 + it))
        metrics = step(_t(j.batch), gen)
        assert set(metrics) == set(jm), set(metrics) ^ set(jm)
        for key, ref in jm.items():
            np.testing.assert_allclose(metrics[key].item(), float(ref), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {it} {key}")
        for path, g in leaves_to_jax(ts.model, grads=True).items():
            _close(f"step {it} grad {path}", g, jgrads[path], GRAD_RTOL)
        want = _jax_state_flat(jts)
        ours = leaves_to_jax(ts.model)
        for path in _stats(want):
            _close(f"step {it} {path}", ours[path], want[path], GRAD_RTOL)
            assert np.abs(ours[path] - init[path]).min() > 0
        _close_params({p: v for p, v in ours.items() if not p.endswith(STATS)},
                      {p: v for p, v in want.items() if not p.endswith(STATS)},
                      jgrads, cfg.learning_rate, f"step {it}")
    assert ts.step == int(jts.step) == 2


def test_attacked_step_matches_jax(j):
    """make_attacked_train_step with the fused BarlowTwins attack against the
    JAX package's one-program step on the same weights, batch and tables:
    the loss within rtol 1e-5 and every metric (num_changes and change_rate
    among them), the gradient of every parameter against the JAX package's
    with its host attack's ids (GRAD_RTOL), and after the step every
    parameter and running statistic; the attack's scoring forward took all
    B * nc rows in each loop."""
    cfg = j.cfg
    vocab, vectors = j.files
    jfused = JF.FusedGreedyAttack(JG.GreedyAttackBarlowTwins(cfg, j.model, j.tok, j.syn))
    clean = {k: v for k, v in j.batch.items() if not k.startswith("attacked_")}
    tables = jfused.prep_tables(clean["text_ids"])
    jstep = JT.make_attacked_train_step(cfg, j.model, j.tx, jfused, donate=False)
    jts1, jm = jstep(j.ts, _j(dict(clean, **tables)), jax.random.PRNGKey(7))
    assert float(jm["num_changes"]) == j.attacked["num_changes"] > 0
    jgrads = _jflat(j.grad(j.params, j.state, _j(dict(
        clean, attacked_text_ids=j.attacked["txt_input_ids"],
        attacked_text_masks=j.attacked["text_masks"]))))

    ts = _port(j)
    fused = _port_attack(j, ts.model, True)
    ours_tables = fused.prep_tables(clean["text_ids"])
    for key, v in tables.items():
        np.testing.assert_array_equal(ours_tables[key], v, err_msg=key)
    step = TT.make_attacked_train_step(cfg, ts, fused)
    FB.reset_launches()
    metrics = step(dict(_t(clean), **ours_tables), torch.Generator().manual_seed(0))
    assert FB.launches == dict.fromkeys(FB.launches, 0)
    assert fused.last_stats["score_forwards"] == fused.last_stats["loops"]
    assert set(metrics) == set(jm), set(metrics) ^ set(jm)
    np.testing.assert_allclose(metrics["barlowtwins_loss"].item(),
                               float(jm["barlowtwins_loss"]), rtol=1e-5)
    for key, ref in jm.items():
        np.testing.assert_allclose(metrics[key].item(), float(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    for path, g in leaves_to_jax(ts.model, grads=True).items():
        _close(f"grad {path}", g, jgrads[path], GRAD_RTOL)
    want, ours = _jax_state_flat(jts1), leaves_to_jax(ts.model)
    for path in _stats(want):
        _close(path, ours[path], want[path], GRAD_RTOL)
    _close_params({p: v for p, v in ours.items() if not p.endswith(STATS)},
                  {p: v for p, v in want.items() if not p.endswith(STATS)},
                  jgrads, cfg.learning_rate, "attacked step")


def test_greedy_extras_match_jax_and_leave_the_stats(j):
    """train/loop.py:make_greedy_extras_fn for barlowtwins: (k, B, adv_lr) of
    the JAX package's greedy_attack_extras, k within GRAD_RTOL; the running
    statistics unchanged."""
    ts = _port(j)
    before = _stats(leaves_to_jax(ts.model))
    clean = _t({k: v for k, v in j.batch.items() if not k.startswith("attacked_")})
    k, psb, lam = TL.make_greedy_extras_fn(j.cfg, ts.model)(ts, clean)
    _close("keys", k, j.extras[0], GRAD_RTOL)
    assert (psb, lam) == (int(j.extras[1]), j.extras[2])
    after = _stats(leaves_to_jax(ts.model))
    assert all(np.array_equal(after[p], before[p]) for p in before)


def test_accum_two_matches_jax(j):
    """accum 2 on two micro-batches (the captions and their swaps as the
    text view, then the swaps and the captions) against make_train_step(
    accum=2): mid-cycle the parameters stay and the running statistics move;
    after each micro-step every parameter and statistic as the JAX step
    leaves it."""
    cfg = j.cfg.replace(max_steps=4)
    _, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=j.params,
                                       state=j.state, max_steps=4, accum=2)
    jstep = JT.make_train_step(cfg, j.model, tx, donate=False, max_steps=4, accum=2)
    second = dict(j.batch, attacked_text_ids=j.batch["text_ids"],
                  text_ids=j.batch["attacked_text_ids"])
    batches = [j.batch, second]
    g0 = j.grad(j.params, j.state, _j(batches[0]))
    g1 = j.grad(j.params, j.state, _j(batches[1]))
    jgrads = _jflat(jax.tree.map(lambda a, b: (a + b) / 2, g0, g1))
    ts = TT.create_train_state(cfg, max_steps=4, model=_port_of(cfg, j.params, j.state),
                               device="cpu", accum=2)
    step = TT.make_train_step(cfg, ts, max_steps=4)
    gen = torch.Generator().manual_seed(0)
    for it, b in enumerate(batches):
        before = leaves_to_jax(ts.model)
        jts, jm = jstep(jts, _j(b), jax.random.PRNGKey(7 + it))
        metrics = step(_t(b), gen)
        np.testing.assert_allclose(metrics["total_loss"].item(), float(jm["total_loss"]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"micro-step {it}")
        ours, want = leaves_to_jax(ts.model), _jax_state_flat(jts)
        for path in _stats(want):
            _close(f"micro-step {it} {path}", ours[path], want[path], GRAD_RTOL)
            assert not np.array_equal(ours[path], before[path]), (it, path)
        params = {p: v for p, v in ours.items() if not p.endswith(STATS)}
        if it == 0:      # mid-cycle: no update
            assert all(np.array_equal(v, before[p]) for p, v in params.items())
        _close_params(params, {p: v for p, v in want.items() if not p.endswith(STATS)},
                      jgrads, cfg.learning_rate, f"micro-step {it}")
    assert ts.step == int(jts.step) == 2


def test_param_groups_match_jax(j):
    """param_group_labels against the JAX package's on a BarlowTwins model:
    the head at the base rate (the reference's "barlowtwinshead" quirk),
    its BatchNorm affine weights with weight decay (no "norm" in their
    path), its statistics out of every group (the JAX package labels them
    frozen: here they are buffers)."""
    jlabels = _jflat(JS.param_group_labels(j.params))
    model = _port_of(j.cfg, j.params, j.state)
    labels = TS.param_group_labels(model)
    for name, label in labels.items():
        assert label == str(jlabels[_jax_path(name, jlabels)]), name
    assert labels["barlowtwins_head.projector.1.weight"] == TS.BASE_DECAY
    assert labels["barlowtwins_head.projector.1.bias"] == TS.BASE_NO_DECAY
    assert labels["barlowtwins_head.projector.0.weight"] == TS.BASE_DECAY
    frozen = {p for p, lab in jlabels.items() if str(lab) == TS.FROZEN}
    buffers = {n.replace(".", "/") for n, _ in model.named_buffers()}
    assert frozen == buffers and len(buffers) == 6
    optimizer, _, _ = TS.make_optimizer(j.cfg, model, 10)
    in_groups = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert all(id(b) not in in_groups for b in model.buffers())


def test_model_and_state_dict(j):
    """ViLT builds the head from cfg.bt_proj_dims and no momentum twins or
    queue; leaves_to_jax gives the statistics under the JAX paths; a
    reference state dict's num_batches_tracked entries are skipped."""
    model = _port_of(j.cfg, j.params, j.state)
    assert not any(n.startswith("k_") for n, _ in model.named_parameters())
    assert not hasattr(model, "proj_queue")
    assert model.barlowtwins_head.projector["6"].weight.shape == (64, 64)
    ours, want = leaves_to_jax(model), _jflat(j.params)
    assert set(ours) == set(want)
    sd = dict(model.state_dict(), **{"barlowtwins_head.norm.num_batches_tracked":
                                     torch.tensor(3)})
    skipped = ViLT(j.cfg).load_reference_state_dict(sd)
    assert skipped == ["barlowtwins_head.norm.num_batches_tracked"]


# ------------------------------------------------------ Trainer and CLI
def test_cli_trains_barlowtwins_on_the_cpu(files, tmp_path, capsys):
    """``cli.run with task_barlowtwins ... device=cpu``: one optimizer step
    (the fused greedy attack inside the step, one PGD step), validation and
    the checkpoints; ``last`` loads back equal into a fresh ViLT, its
    running statistics included and moved from their initial values; the
    same command without a card and without device=cpu raises."""
    from rmcl_tpu_torch.cli.run import main
    from rmcl_tpu_torch.core.config import build_config as port_build_config
    from rmcl_tpu_torch.serve import load_state_dict_file
    from rmcl_tpu_torch.train.checkpoint import MODEL_FILE, CheckpointManager
    from tests.test_torch_trainer import CAPTIONS, write_tables
    vocab, vectors = files
    V = WordPieceTokenizer(vocab).vocab_size
    d = tmp_path / "data"
    d.mkdir()
    write_tables(str(d), CAPTIONS, n_train=2, n_test=2)
    args = ["with", "task_barlowtwins", "fast_dev_run=True", f"data_root={d}",
            f"tokenizer={vocab}", f"embedding_path={vectors}", "sim_path=",
            "hidden_size=32", "num_heads=2", "num_layers=2", "patch_size=16",
            "image_size=32", "image_bucket_hw=(32,48)", "max_text_len=12", f"vocab_size={V}",
            "max_image_len=4", "compute_dtype=float32", "drop_rate=0.0",
            "bt_proj_dims=(64,64,64)", "image_view=True", "text_view=True",
            "adv_steps_img=1", "n_candidates=3", "max_loops=2", "batch_size=2",
            "num_workers=0", f"log_dir={tmp_path / 'log'}"]
    assert main(args + ["device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "val/the_metric" in out or "val_the_metric" in out
    workdir = tmp_path / "log" / "barlowtwins"
    ckpt = CheckpointManager(str(workdir))
    assert ckpt.has("last")
    sd = load_state_dict_file(os.path.join(ckpt.checkpoint_dir("last"), MODEL_FILE))
    fresh = ViLT(port_build_config(
        "task_barlowtwins", hidden_size=32, num_heads=2, num_layers=2, patch_size=16,
        image_size=32, image_bucket_hw=(32, 48), max_text_len=12, vocab_size=V,
        max_image_len=4, bt_proj_dims=(64, 64, 64)))
    assert fresh.load_reference_state_dict(sd) == []
    back = fresh.state_dict()
    assert all(torch.equal(back[k], sd[k]) for k in back)
    assert not torch.equal(back["barlowtwins_head.projector.1.running_mean"],
                           torch.zeros(64))
    assert not torch.equal(back["barlowtwins_head.norm.running_var"], torch.ones(64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
