"""The port's pretraining tasks against the JAX package on the CPU in fp32: the
IPOT solver (objectives/ot.py), MPP's masking and the masked visual
embedding (models/vit.py), the five objectives (objectives/pretrain.py:
compute_mlm, compute_mpp, compute_mppd, compute_mpfr, compute_itm_wpa), two
task_mlm_itm_mpp training steps, accumulation over two micro-steps and the
parameter groups.  The sizes: C = 32, 2 layers, 4 heads, patch 16, the 32 x 48
bucket (6 patches), max_text_len 12, B = 4, drop_rate 0, the vocabulary of
make_tiny_vocab, weights carried by compat/from_jax.py and moved off their
initial values (tests/test_torch_downstream.py:_moved), mask_token included.

The random draws cannot match: the port draws the ITM permutation and the MPP
masks from a torch generator (train/step.py:pretrain_draws), the JAX package
from its keys.  So the port is fed the JAX package's draws, replayed from the
keys along the path the JAX package splits them (``_replay``), and each test
holds the replay to what the JAX side drew: ``itm_labels`` equal, and the
MPP masks equal to where the JAX labels are not -100.

Tolerances: values, per-sample keys and gradients within 1e-5 x max(1,
max|ref|); MPP labels equal, but where the JAX package's mean times 255 lies
within 1e-4 of an integer (a truncation the two reduction orders may put on
either side); after an AdamW step every parameter as
tests/test_torch_train.py:_close_params holds the MoCo step's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rmcl_tpu.core.config import active_tasks, build_config, loss_names
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models import vit as JV
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.objectives import ot as JOT
from rmcl_tpu.objectives import pretrain as JP
from rmcl_tpu.train import schedule as JS
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
from rmcl_tpu_torch.data.mlm import MLMCollator
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.models import vit as TVIT
from rmcl_tpu_torch.models.vilt import draw_seeds
from rmcl_tpu_torch.objectives import ot as TOT
from rmcl_tpu_torch.objectives import pretrain as TP
from rmcl_tpu_torch.train import schedule as TS
from rmcl_tpu_torch.train import step as TT
from tests.conftest import make_fake_batch
from tests.test_torch_downstream import _moved
from tests.test_torch_train import _close, _close_params, _jax_path, _jflat, _port_of
from tests._torch_threads import one_thread  # noqa: F401

ALL = ("itm", "mlm", "mpp", "mppd", "mpfr")
WORDS = ["dog", "puppy", "cat", "kitten", "red", "big", "runs", "park", "street", "road",
         "the", "a", "in", "on", "small", "car"]
SENTENCES = ["the dog runs in the park", "a small cat on the road", "big red car",
             "puppy runs on the street in the park"]
B = len(SENTENCES)
KEY = jax.random.PRNGKey(18)


def _cfg(vocab_size, losses=ALL, **kw):
    base = dict(
        hidden_size=32, num_heads=4, num_layers=2, patch_size=16, image_size=32,
        image_bucket_hw=(32, 48), max_text_len=12, vocab_size=vocab_size,
        loss_names=loss_names({t: 1 for t in losses}), use_pallas_attention=False,
        compute_dtype="float32", drop_rate=0.0, max_image_len=-1, learning_rate=1e-3,
        weight_decay=0.01, max_steps=100, warmup_steps=0)
    base.update(kw)
    return build_config(**base)


def make_batch(cfg, tok, seed=0):
    """Captions (the port's MLM collator masks them), ragged float images as
    patch rows and the false images ITM swaps in."""
    ids, masks = tok.batch_encode(SENTENCES, cfg.max_text_len)
    ids, masks = ids.astype(np.int32), masks.astype(np.int32)
    special = np.isin(ids, [tok.pad_token_id, tok.cls_token_id, tok.sep_token_id])
    mlm_ids, mlm_labels = MLMCollator(tok, seed=seed)(ids, special)
    rows = [hwc_to_patch_rows(make_fake_batch(cfg, batch=B, seed=seed + s)["image"],
                              cfg.patch_size) for s in (1, 2)]
    return {"image": rows[0], "false_image_0": rows[1], "text_ids": ids, "text_masks": masks,
            "text_ids_mlm": mlm_ids.astype(np.int32),
            "text_labels_mlm": mlm_labels.astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------- the JAX draws
def _mpp_masks(key, shape):
    """mask_tokens' two masks from the key visual_embed hands it."""
    k1, k2 = jax.random.split(key)
    masked = jax.random.bernoulli(k1, 0.15, shape)
    replaced = jax.random.bernoulli(k2, 0.8, shape) & masked
    return torch.from_numpy(np.stack([np.asarray(masked), np.asarray(replaced)]))


def _objective_draw(task, key, n_patches, B=B):
    """What compute_<task>(rng=key) draws: the MPP masks from infer's second
    key, the ITM labels from the second of three."""
    if task == "itm":
        base = jnp.concatenate([jnp.ones((B // 2,), jnp.int32),
                                jnp.zeros((B - B // 2,), jnp.int32)])
        perm = jax.random.permutation(jax.random.split(key, 3)[1], base)
        return torch.from_numpy(np.array(perm)).long()
    if task in TT.MASKED_PATCH:
        return _mpp_masks(jax.random.split(key, 3)[1], (B, n_patches))
    return None


def _replay(cfg, key, n_patches, B=B):
    """pretrain_draws' dict as compute_all_tasks(rng=key) draws: one key per
    active task, in the order of loss_names."""
    tasks = active_tasks(cfg)
    keys = dict(zip(tasks, jax.random.split(key, len(tasks))))
    return {t: _objective_draw(t, keys[t], n_patches, B) for t in tasks
            if t in TT.PRETRAIN and t != "mlm"}


def _margins(rows, max_image_len):
    """(B, L+1, 3): the distance of the JAX package's mean x 255 from the
    nearest integer, per label of the masked embedding (inf on the class
    token's row), the selection applied as visual_embed applies it."""
    scaled = np.asarray(jax.jit(lambda r: JV.patch_mean_rgb(r * 0.5 + 0.5) * 255)(rows))
    margin = np.abs(scaled - np.round(scaled))
    n = rows.shape[1]
    if 0 < max_image_len < n:
        valid = rows[:, :, :3].sum(-1) != 0
        sel = np.argsort(~valid, axis=1, kind="stable")[:, :max_image_len]
        margin = np.take_along_axis(margin, sel[..., None], axis=1)
    return np.concatenate([np.full((rows.shape[0], 1, 3), np.inf), margin], axis=1)


def _labels_equal(what, ours, ref, margin):
    """MPP labels equal but at a truncation boundary; prints the margin of
    every label that differs."""
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, what
    differ = ours != ref
    if differ.any():
        print(f"{what}: {int(differ.sum())} labels differ at margins {margin[differ]}")
    assert (margin[differ] < 1e-4).all(), (what, margin[differ])
    assert ((ours == -100) == (ref == -100)).all(), what


# ------------------------------------------------------------------- IPOT
def test_ipot_matches_jax():
    """cost_matrix_cosine, ipot (50 rounds, beta 0.5, k 1 and k 2), trace_bmm
    and optimal_transport_dist on seeded features with padded rows and
    columns: within 1e-5 x max(1, max|ref|); the plan carries no gradient,
    and the distance's gradient (through the cost only) equals the JAX
    package's."""
    r = np.random.RandomState(0)
    Bo, M, N, D = 3, 7, 9, 16
    x, y = r.randn(Bo, M, D).astype(np.float32), r.randn(Bo, N, D).astype(np.float32)
    x_pad = np.zeros((Bo, M), bool)
    y_pad = np.zeros((Bo, N), bool)
    for b, (m, n) in enumerate([(7, 9), (4, 6), (2, 8)]):
        x_pad[b, m:], y_pad[b, n:] = True, True
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    cost_j = jax.jit(JOT.cost_matrix_cosine)(jnp.asarray(x), jnp.asarray(y))
    cost_t = TOT.cost_matrix_cosine(torch.from_numpy(x), torch.from_numpy(y))
    _close("cost", cost_t, cost_j)
    C = np.where(joint, 0.0, np.asarray(cost_j)).astype(np.float32)
    x_len = (M - x_pad.sum(1)).astype(np.float32)
    y_len = (N - y_pad.sum(1)).astype(np.float32)
    jipot = jax.jit(JOT.ipot, static_argnums=(6, 7, 8))
    for k in (1, 2):
        T_j = jipot(jnp.asarray(C), jnp.asarray(x_len), jnp.asarray(x_pad),
                    jnp.asarray(y_len), jnp.asarray(y_pad), jnp.asarray(joint), 0.5, 50, k)
        Ct = torch.from_numpy(C).requires_grad_(True)
        T_t = TOT.ipot(Ct, *map(torch.from_numpy, (x_len, x_pad, y_len, y_pad, joint)),
                       0.5, 50, k)
        assert not T_t.requires_grad
        _close(f"plan k={k}", T_t, T_j)
        assert np.abs(np.asarray(T_j)).max() > 1e-3
        _close(f"trace k={k}", TOT.trace_bmm(torch.from_numpy(C), T_t),
               np.einsum("bmn,bnm->b", C, np.asarray(T_j)))

    def jdist(a, b):
        return JOT.optimal_transport_dist(a, b, jnp.asarray(x_pad), jnp.asarray(y_pad)).sum()

    dist_j, (gx_j, gy_j) = jax.jit(jax.value_and_grad(jdist, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    dist_t = TOT.optimal_transport_dist(xt, yt, torch.from_numpy(x_pad),
                                        torch.from_numpy(y_pad)).sum()
    dist_t.backward()
    _close("distance", dist_t, dist_j)
    _close("d distance / d x", xt.grad, gx_j)
    _close("d distance / d y", yt.grad, gy_j)


# ------------------------------------------------------ the JAX side, once
class J:
    """The five-head model's JAX side: config, weights and batch, and each
    objective's ``value_and_grad`` compiled once on first use (``fn``),
    ``(params, batch, key) -> ((loss, ret), gradients)``; ``ret_grads`` is its
    output at the weights and batch here, the key KEY."""

    def __init__(self, vocab):
        self.tok = WordPieceTokenizer(vocab)
        self.cfg = cfg = _cfg(self.tok.vocab_size)
        self.model = ViLTModel(cfg)
        params, self.state = jax.jit(lambda k: init_vilt(k, cfg))(jax.random.PRNGKey(0))
        self.params = _moved(params)
        self.batch = make_batch(cfg, self.tok)
        self.n_patches = self.batch["image"].shape[1]
        self._fns, self._rets = {}, {}

    @functools.cached_property
    def port(self):
        return _port_of(self.cfg, self.params, self.state)

    def fn(self, task):
        if task not in self._fns:
            compute = {"mlm": JP.compute_mlm, "mpp": JP.compute_mpp, "mppd": JP.compute_mppd,
                       "mpfr": JP.compute_mpfr, "itm": JP.compute_itm_wpa}[task]
            keys = JT._TASK_LOSS_KEYS[task]

            def loss(p, b, key):
                ret = compute(self.model, p, b, rng=key, train=True)
                return sum(ret[k] for k in keys), ret

            self._fns[task] = jax.jit(jax.value_and_grad(loss, has_aux=True))
        return self._fns[task]

    def ret_grads(self, task):
        if task not in self._rets:
            (_, ret), grads = self.fn(task)(self.params, _j(self.batch), KEY)
            self._rets[task] = (jax.tree.map(np.asarray, ret), _jflat(grads))
        return self._rets[task]


@pytest.fixture(scope="module")
def j(tmp_path_factory):
    return J(make_tiny_vocab(str(tmp_path_factory.mktemp("pretrain") / "vocab.txt"), WORDS))


@pytest.mark.parametrize("max_image_len", [-1, 4], ids=["every_patch", "selected"])
def test_masked_visual_embed_matches_jax(j, max_image_len):
    """ViT.visual_embed_masked against visual_embed(mask_it=True) on the same
    rows and the replayed masks: the embeddings within 1e-5 x max(1,
    max|ref|), the mask and the grid coordinates equal, the labels equal
    (truncation rule); some patches masked and some replaced by the mask
    token; mask_tokens alone on every patch too."""
    cfg = j.cfg.replace(max_image_len=max_image_len)
    rows = j.batch["image"]
    tr = j.port.transformer
    key = jax.random.PRNGKey(5)
    x_j, m_j, (pidx_j, _), lab_j = jax.jit(lambda p, r, k: JV.visual_embed(
        p, r, spec=ViLTModel(cfg).spec, max_image_len=max_image_len, mask_it=True, rng=k,
        deterministic=True, dtype=jnp.float32, grid_hw=cfg.grid_hw))(
        j.params["transformer"], jnp.asarray(rows), key)
    masks = _mpp_masks(key, (B, j.n_patches))
    assert int(masks[0].sum()) >= 2 and int(masks[1].sum()) >= 1
    with torch.no_grad():
        x, m, lab, pidx = tr.visual_embed_masked(torch.from_numpy(rows), cfg.grid_hw,
                                                 max_image_len, torch.float32, *masks)
    _close("embedding", x, x_j)
    assert np.array_equal(m.numpy(), np.asarray(m_j))
    assert np.array_equal(pidx.numpy(), np.asarray(pidx_j))
    _labels_equal("labels", lab, lab_j, _margins(rows, max_image_len))
    if max_image_len < 0:
        # the replay is the JAX package's draw: masked and valid where labelled
        valid = np.asarray(m_j)[:, 1:] == 1
        assert np.array_equal(np.asarray(lab_j)[:, 1:, 0] != -100, masks[0].numpy() & valid)
        f_j, l_j = jax.jit(lambda k, r, t: JV.mask_tokens(
            k, r, jnp.zeros((B, j.n_patches, 32)), t, cfg.patch_size))(
            key, jnp.asarray(rows), j.params["transformer"]["mask_token"])
        f_t, l_t = TVIT.mask_tokens(torch.from_numpy(rows), torch.zeros(B, j.n_patches, 32),
                                    tr.mask_token, *masks)
        _close("mask_tokens features", f_t.detach(), f_j)
        _labels_equal("mask_tokens labels", l_t, l_j, _margins(rows, -1)[:, 1:])


# ------------------------------------------------------------ objectives
def _port_objective(j, task, draw):
    model = j.port
    model.zero_grad(set_to_none=True)
    seeds = draw_seeds(torch.Generator().manual_seed(0), 1, j.cfg.num_layers, B, "cpu")[0]
    fn = {"mlm": TP.compute_mlm, "mpp": TP.compute_mpp, "mppd": TP.compute_mppd,
          "mpfr": TP.compute_mpfr, "itm": TP.compute_itm_wpa}[task]
    args = () if draw is None else (draw,)
    ret = fn(model, _t(j.batch), *args, seeds=seeds, train=True)
    sum(ret[k] for k in TT._TASK_LOSS_KEYS[task]).backward()
    return ret, leaves_to_jax(model, grads=True)


@pytest.mark.parametrize("task", ["mlm", "mpp", "mppd", "mpfr", "itm"])
def test_objective_matches_jax(j, task):
    """compute_<task> on the training path against the JAX package's on the
    JAX draws: every key of its output (losses, per-sample rows, logits,
    labels, step accuracies) and the gradient of its loss with respect to
    every parameter; a parameter the loss does not reach has no gradient in
    the port and a zero one in the JAX package."""
    ref, jgrads = j.ret_grads(task)
    draw = _objective_draw(task, KEY, j.n_patches)
    ret, grads = _port_objective(j, task, draw)
    assert set(ret) == set(ref), set(ret) ^ set(ref)
    for k, want in ref.items():
        if k == "mpp_labels":
            _labels_equal(k, ret[k], want, _margins(j.batch["image"], -1))
        elif k.endswith(("_labels", "_ids")) and want.dtype.kind in "iu":
            assert np.array_equal(ret[k].numpy(), want), k
        else:
            _close(k, ret[k], want)
    if task == "itm":
        assert np.array_equal(ret["itm_labels"].numpy(), ref["itm_labels"])
        assert abs(float(ref["itm_wpa_loss"])) > 1e-4
    if task == "mpp":
        assert (ref["mpp_labels"] != -100).any()
    for path, g in grads.items():
        _close(f"{task} grad {path}", g, jgrads[path])
    unreached = [p for p in jgrads if p not in grads]
    assert all(np.abs(jgrads[p]).max() == 0 for p in unreached), unreached
    reached_mask = "transformer/mask_token" in grads
    assert reached_mask == (task in TT.MASKED_PATCH), task


# --------------------------------------------------------------- steps
STEP_TASKS = ("itm", "mlm", "mpp")      # task_mlm_itm_mpp, in loss_names' order
OTHER_HEADS = ("mppd_score", "mpfr_score")


def _jax_micro_step(j, cfg, params, key):
    """The JAX package's compute_all_tasks(rng=key) for task_mlm_itm_mpp,
    composed from the objectives compiled once: each task on its key of
    split(key, 3), the gradient the sum of theirs.  Returns (metrics as
    make_train_step's without lr, gradients of the task_mlm_itm_mpp leaves)."""
    keys = dict(zip(STEP_TASKS, jax.random.split(key, len(STEP_TASKS))))
    full = dict(params, **{h: j.params[h] for h in OTHER_HEADS})
    metrics, grads, total = {}, [], 0.0
    for t in STEP_TASKS:
        (_, ret), g = j.fn(t)(full, _j(j.batch), keys[t])
        metrics.update({k: v for k, v in ret.items() if v.ndim == 0})
        total = total + sum(float(ret[k]) for k in JT._TASK_LOSS_KEYS[t])
        grads.append({k: v for k, v in g.items() if k not in OTHER_HEADS})
    metrics["total_loss"] = total
    return metrics, _tree_sum(*grads)


@jax.jit
def _tree_sum(*trees):
    return jax.tree.map(lambda *a: sum(a), *trees)


def _two_steps(j, accum, monkeypatch):
    """Two micro-steps of task_mlm_itm_mpp (accum 1: two optimizer steps;
    accum 2: one) on the port, on the JAX package's draws, and on the JAX
    package as its step composes them: gradient, then the optax update of
    ``create_train_state(accum=accum)``.  Returns (port ts, JAX params,
    per-step (port metrics, JAX metrics), the JAX gradients _close_params
    reads, port step-one gradients)."""
    cfg = j.cfg.replace(loss_names=loss_names({t: 1 for t in STEP_TASKS}))
    params = {k: v for k, v in j.params.items() if k not in OTHER_HEADS}
    _, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=params,
                                       state=j.state, accum=accum)
    lr = JS.make_lr_schedule(cfg, cfg.max_steps)
    keys = [jax.random.PRNGKey(21 + it) for it in range(2)]
    draws = iter([_replay(cfg, k, j.n_patches) for k in keys])
    monkeypatch.setattr(TT, "pretrain_draws", lambda *a, **kw: next(draws))
    ts = TT.create_train_state(cfg, model=_port_of(cfg, params, j.state), device="cpu",
                               accum=accum)
    step = TT.make_train_step(cfg, ts)
    gen = torch.Generator().manual_seed(0)
    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    jparams, opt_state, pairs, gs = jts.params, jts.opt_state, [], []
    for it in range(2):
        jm, g = _jax_micro_step(j, cfg, jparams, keys[it])
        jm["lr"] = lr(it // accum)
        jparams, opt_state = update(g, opt_state, jparams)
        pairs.append((step(_t(j.batch), gen), jm))
        gs.append(g)
        if it == 0:
            tgrads = leaves_to_jax(ts.model, grads=True)
    # the gradient the last update applied decides which elements are firm:
    # step one's for accum 1 (as tests/test_torch_train.py holds two MoCo
    # steps), the cycle's mean for accum 2
    jgrads = _jflat(gs[0] if accum == 1 else jax.tree.map(lambda a, b: (a + b) / 2, *gs))
    return ts, jparams, pairs, jgrads, tgrads


def test_two_mlm_itm_mpp_steps_match_jax(j, monkeypatch):
    """Two task_mlm_itm_mpp steps of make_train_step against the JAX
    package's step on the same weights and batch and its draws: every
    scalar metric, total_loss and lr; the gradient of every parameter at step
    one (mask_token's among them); after the two steps every parameter
    (_close_params, lr 1e-3)."""
    ts, jparams, pairs, jgrads, tgrads = _two_steps(j, 1, monkeypatch)
    for it, (m, jm) in enumerate(pairs):
        assert set(m) == set(jm), set(m) ^ set(jm)
        for key, ref in jm.items():
            # step two starts from parameters that differ within _close_params' bounds
            np.testing.assert_allclose(m[key].item(), float(ref),
                                       rtol=1e-4 if it == 0 else 2e-3, atol=1e-5,
                                       err_msg=f"step {it} {key}")
    assert set(tgrads) == set(jgrads)
    for path, g in tgrads.items():   # step one's: jgrads is step one's at accum 1
        _close(f"grad {path}", g, jgrads[path])
    assert np.abs(tgrads["transformer/mask_token"]).max() > 0
    _close_params(leaves_to_jax(ts.model), _jflat(jparams), jgrads, 1e-3, "step 2")
    assert ts.step == 2


def test_mlm_itm_mpp_accum_two_matches_jax(j, monkeypatch):
    """accum 2: two micro-steps and one optimizer step (optax MultiSteps in
    the JAX package): the micro-steps' metrics, every parameter unmoved after
    the first and as _close_params holds it after the cycle."""
    ts, jparams, pairs, jgrads, _ = _two_steps(j, 2, monkeypatch)
    for it, (m, jm) in enumerate(pairs):
        for key, ref in jm.items():
            np.testing.assert_allclose(m[key].item(), float(ref), rtol=1e-4, atol=1e-5,
                                       err_msg=f"micro-step {it} {key}")
    assert ts.step == 2
    _close_params(leaves_to_jax(ts.model), _jflat(jparams), jgrads, 1e-3, "accum 2")


def test_pretrain_heads_param_groups_match_jax(j):
    """The masked-patch heads, the MLM and ITM heads and mask_token fall in
    the JAX package's parameter groups (weight decay, no head multiplier)."""
    jlabels = _jflat(JS.param_group_labels(j.params))
    labels = TS.param_group_labels(j.port)
    for name, label in labels.items():
        assert label == str(jlabels[_jax_path(name, jlabels)]), name
    heads = [n for n in labels if n.split(".")[0] in ("mpp_score", "mppd_score", "mpfr_score",
                                                       "mlm_score", "itm_score")]
    assert len(heads) == 4 * 6 + 2
    assert labels["transformer.mask_token"] == str(jlabels["transformer/mask_token"])


def test_pretrain_weights_carry_across_and_back(j):
    """The JAX package's five pretraining heads and mask_token load into the
    port's ViLT (compat/from_jax.py, nothing skipped) and come back from
    leaves_to_jax unchanged."""
    ours, want = leaves_to_jax(j.port), _jflat(j.params)
    assert set(ours) == set(want)
    assert all(np.array_equal(ours[k], want[k]) for k in want)
    assert j.port.mpp_score.decoder.weight.shape == (768, 32)
    assert j.port.mppd_score.decoder.weight.shape == (16 * 16 * 3, 32)
    assert j.port.mpfr_score.decoder.weight.shape == (32, 32)
    assert np.abs(want["transformer/mask_token"]).max() > 0


def test_draws_are_the_generators(j):
    """pretrain_draws: the same draws from the same generator seed, other
    draws from another; B // 2 ones in the ITM labels; masks (2, B, N) with
    replaced within masked."""
    d = [TT.pretrain_draws(j.cfg, torch.Generator().manual_seed(s), 8, 30, "cpu")
         for s in (0, 0, 1)]
    assert list(d[0]) == ["itm", "mpp", "mppd", "mpfr"]
    assert all(torch.equal(d[0][k], d[1][k]) for k in d[0])
    assert not all(torch.equal(d[0][k], d[2][k]) for k in d[0])
    assert d[0]["itm"].dtype == torch.int64 and int(d[0]["itm"].sum()) == 4
    for t in TT.MASKED_PATCH:
        assert d[0][t].shape == (2, 8, 30) and bool((d[0][t][1] <= d[0][t][0]).all())
