"""The port's downstream tasks against the JAX package on the CPU in fp32:
the per-sample losses, the clean tasks' objectives (objectives/downstream.py:
compute_vqa, compute_nlvr2, compute_irtr) and training steps, the NLVR2 PGD
(attacks/pgd.py:make_pgd_nlvr2) and the attacked NLVR2 pass's dropout; the
attacked tasks are in tests/test_torch_downstream_attacked.py, on this file's
helpers.  The sizes: 2 layers, C = 32, 4 heads, vqav2_label_size 16, draw_false_text 3,
max_text_len 12, every patch (max_image_len -1), 2 PGD steps, n_candidates 3,
max_loops 2, greedy_compact_frac 0.5, drop_rate 0 (0.1 where a test says so),
the vocabulary and counter-fitted vectors of tests/test_attacks.py, weights
carried by compat/from_jax.py.

Tolerances: logits and losses within 1e-5 x max(1, max|ref|); gradients
within 1e-5 x max(1, max|ref|) (test_torch_train.py's MoCo tolerances); PGD
deltas within 2.5e-7; the greedy attacks' token ids and change counts
exactly; after an AdamW step every parameter as ``_close_params`` holds the
MoCo step's (2% of the rate where the gradient is firm).  The weights are
moved off their initial values (+ 0.1 x N(0, 1) on every leaf) so that the
class features, and with them the attacks' decisions, differ across a batch.

The JAX package's programs are compiled once per task in the module fixture
``j`` and shared; the port runs eagerly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import pgd as JP
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.objectives import downstream as JD
from rmcl_tpu.objectives import losses as JLoss
from rmcl_tpu.train import loop as JL
from rmcl_tpu.train import schedule as JS
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.attacks.pgd import make_pgd_nlvr2
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.objectives import downstream as TD
from rmcl_tpu_torch.objectives import losses as TLoss
from rmcl_tpu_torch.train import schedule as TS
from rmcl_tpu_torch.train import step as TT
from tests.conftest import make_fake_batch
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_greedy import _write_vectors
from tests.test_torch_train import _close, _jflat, _port_of
from tests._torch_threads import one_thread  # noqa: F401

RTOL = 1e-5
DELTA_ATOL = 2.5e-7
TASKS = ("vqa", "vqa_attacked", "nlvr2", "nlvr2_attacked", "irtr", "irtr_attacked")
ATTACKED = ("vqa_attacked", "nlvr2_attacked", "irtr_attacked")
SENTENCES = ["dog runs in park", "cat sits in street", "big red car on road",
             "small puppy on the road"]
SWAPPED = ["puppy runs in garden", "kitten sits in road", "large crimson auto on street",
           "tiny dog on the street"]
FALSE = 3            # draw_false_text
LABELS = 16          # vqav2_label_size
B = len(SENTENCES)


def _cfg(vocab_size, task, **kw):
    base = dict(
        hidden_size=32, num_heads=4, num_layers=2, patch_size=16, image_size=32,
        image_bucket_hw=(32, 48), max_text_len=12, vocab_size=vocab_size,
        loss_names=loss_names({task: 1}), vqav2_label_size=LABELS, draw_false_text=FALSE,
        use_pallas_attention=False, compute_dtype="float32", drop_rate=0.0,
        max_image_len=-1, image_view=True, text_view=True, adv_steps_img=2,
        adv_lr_img=0.05, adv_max_norm_img=0.005, attack_idx=(True, True),
        temperature=0.07, learning_rate=1e-3, weight_decay=0.01, lr_mult=10,
        max_steps=100, warmup_steps=0, n_candidates=3, max_loops=2,
        greedy_compact_frac=0.5)
    base.update(kw)
    return build_config(**base)


def _moved(params, seed=3, scale=0.1):
    r = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * r.randn(*np.shape(a)),
                                              a.dtype), params)


def make_batch(cfg, tok, sentences=SENTENCES, swapped=SWAPPED, seed=0):
    """Every downstream task's keys on one batch: the image (and NLVR2's two)
    as patch rows, the captions, their swaps as the attacked text, seeded
    VQA soft targets, NLVR2 labels, and the other captions as IRTR's false
    texts."""
    n = len(sentences)
    r = np.random.RandomState(seed)
    ids, masks = tok.batch_encode(sentences, cfg.max_text_len)
    a_ids, a_masks = tok.batch_encode(swapped, cfg.max_text_len)
    img = [hwc_to_patch_rows(make_fake_batch(cfg, batch=n, seed=seed + s)["image"],
                             cfg.patch_size) for s in range(3)]
    targets = (r.rand(n, cfg.vqav2_label_size) * (r.rand(n, cfg.vqav2_label_size) < 0.3))
    out = {"image": img[0], "image_0": img[1], "image_1": img[2],
           "text_ids": ids.astype(np.int32), "text_masks": masks.astype(np.int32),
           "attacked_text_ids": a_ids.astype(np.int32),
           "attacked_text_masks": a_masks.astype(np.int32),
           "vqa_targets": targets.astype(np.float32),
           "answers": (np.arange(n) % 2).astype(np.int32)}
    for i in range(cfg.draw_false_text):
        f_ids, f_masks = tok.batch_encode([sentences[(k + i + 1) % n] for k in range(n)],
                                          cfg.max_text_len)
        out[f"false_text_{i}_ids"] = f_ids.astype(np.int32)
        out[f"false_text_{i}_masks"] = f_masks.astype(np.int32)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _clean(batch):
    return {k: v for k, v in batch.items() if not k.startswith("attacked_")}


def _loss_keys(task):
    return JT._TASK_LOSS_KEYS[task]


def _jax_objective(cfg, model, task):
    """compute_* of ``task`` as compute_all_tasks calls it (its PGD and the
    batch's attacked text for the attacked tasks): (summed loss, ret)."""
    key = jax.random.PRNGKey(7)

    def objective(p, b):
        attacked = dict(image_view=cfg.image_view, attacked_text={
            "text_ids": b["attacked_text_ids"], "text_masks": b["attacked_text_masks"]},
            pgd_fn=JT._build_pgd(cfg, model, task))
        ret = {"vqa": lambda: JD.compute_vqa(model, p, b, rng=key, train=True),
               "nlvr2": lambda: JD.compute_nlvr2(model, p, b, rng=key, train=True),
               "irtr": lambda: JD.compute_irtr(model, p, b, rng=key, train=True,
                                               false_len=FALSE),
               "vqa_attacked": lambda: JD.compute_vqa_attack(
                   model, p, b, rng=key, train=True, **attacked),
               "nlvr2_attacked": lambda: JD.compute_nlvr2_attack(
                   model, p, b, rng=key, train=True, **attacked),
               "irtr_attacked": lambda: JD.compute_irtr_attacked(
                   model, p, b, rng=key, train=True, false_len=FALSE, **attacked)}[task]()
        return sum(ret[k] for k in _loss_keys(task)), ret

    return jax.jit(jax.value_and_grad(objective, has_aux=True))


class Side:
    """One task's JAX side: config, model, weights, batch and train state;
    on first use the objective's (ret, gradients) and, for an attacked task,
    the greedy host attack's extras and result."""

    def __init__(self, j, task):
        self.task, self.tok, self.syn = task, j.tok, j.syn
        self.cfg = cfg = _cfg(j.tok.vocab_size, task)
        self.model = ViLTModel(cfg)
        params, self.state = init_vilt(jax.random.PRNGKey(0), cfg)
        self.params = _moved(params)
        self.batch = make_batch(cfg, j.tok)
        _, self.ts, self.tx = JT.create_train_state(jax.random.PRNGKey(0), cfg,
                                                    params=self.params, state=self.state)

    @functools.cached_property
    def objective(self):
        return _jax_objective(self.cfg, self.model, self.task)

    @functools.cached_property
    def ret_grads(self):
        (_, ret), grads = self.objective(self.params, _j(self.batch))
        return jax.tree.map(np.asarray, ret), _jflat(grads)

    @functools.cached_property
    def extras(self):
        cfg, task = self.cfg, self.task
        return jax.jit(lambda p, st, b: JL.greedy_attack_extras(
            cfg, self.model, task, p, st, b))(self.params, self.state, _j(_clean(self.batch)))

    @functools.cached_property
    def attacked(self):
        host = JG_ATTACKERS[self.task](self.cfg, self.model, self.tok, self.syn)
        return host.adv_attack_samples(self.params, _clean(self.batch), self.extras)


class J:
    def __init__(self, files):
        self.files = files
        self.tok = JTokenizer(files[0])
        self.syn = JG.SynonymTable(files[1], 3, 0.5)
        self.sides = {}

    def __call__(self, task) -> Side:
        if task not in self.sides:
            self.sides[task] = Side(self, task)
        return self.sides[task]


JG_ATTACKERS = {"vqa_attacked": JG.GreedyAttackVqa, "nlvr2_attacked": JG.GreedyAttackNlvr2,
                "irtr_attacked": JG.GreedyAttackIrtr}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("downstream")
    return (make_tiny_vocab(str(d / "vocab.txt"), WORDS),
            _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS))


@pytest.fixture(scope="module")
def j(files):
    return J(files)


def _port(s, **kw):
    cfg = s.cfg.replace(**kw)
    return TT.create_train_state(cfg, model=_port_of(cfg, s.params, s.state), device="cpu")


def _port_objective(ts, cfg, task, batch, train=True, seeds=None):
    attacked = dict(image_view=cfg.image_view, attacked_text={
        "text_ids": batch["attacked_text_ids"], "text_masks": batch["attacked_text_masks"]},
        pgd_fn=TT._build_pgd(cfg, ts, task))
    common = dict(block_matrices=ts.block_matrices, train=train, seeds=seeds)
    model = ts.model
    return {"vqa": lambda: TD.compute_vqa(model, batch, **common),
            "nlvr2": lambda: TD.compute_nlvr2(model, batch, **common),
            "irtr": lambda: TD.compute_irtr(model, batch, false_len=FALSE, **common),
            "vqa_attacked": lambda: TD.compute_vqa_attack(model, batch, **common, **attacked),
            "nlvr2_attacked": lambda: TD.compute_nlvr2_attack(model, batch, **common,
                                                              **attacked),
            "irtr_attacked": lambda: TD.compute_irtr_attacked(
                model, batch, false_len=FALSE, **common, **attacked)}[task]()


# ---------------------------------------------------------------- losses
def test_per_sample_losses_match_jax():
    """cross_entropy_per_sample with ignored positions (1-d and 2-d labels)
    and bce_rowsum_with_logits against the JAX package's; the per-sample
    sums recombine to the batch losses."""
    r = np.random.RandomState(0)
    for shape in ((6,), (3, 5)):
        logits = r.randn(*shape, 7).astype(np.float32)
        labels = r.randint(0, 7, shape).astype(np.int64)
        labels.reshape(-1)[::4] = -100
        ours = TLoss.cross_entropy_per_sample(torch.from_numpy(logits), torch.from_numpy(labels))
        ref = JLoss.cross_entropy_per_sample(jnp.asarray(logits), jnp.asarray(labels))
        for a, b in zip(ours, ref):
            _close(f"ce_ps {shape}", a, b, RTOL)
        whole = TLoss.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
        np.testing.assert_allclose((ours[0].sum() / ours[1].sum()).item(), whole.item(),
                                   rtol=1e-6)
    x, t = r.randn(4, LABELS).astype(np.float32), r.rand(4, LABELS).astype(np.float32)
    rows = TLoss.bce_rowsum_with_logits(torch.from_numpy(x), torch.from_numpy(t))
    _close("bce rowsum", rows, JLoss.bce_rowsum_with_logits(jnp.asarray(x), jnp.asarray(t)), RTOL)
    np.testing.assert_allclose(rows.mean().item(), LABELS * TLoss.bce_with_logits(
        torch.from_numpy(x), torch.from_numpy(t)).item(), rtol=1e-6)


# ------------------------------------------------------------ objectives
CLEAN = ("vqa", "nlvr2", "irtr")


@pytest.mark.parametrize("task", CLEAN)
def test_objective_matches_jax(j, task):
    """The clean tasks' compute_* against the JAX package's
    (``objective_matches_jax``)."""
    objective_matches_jax(j, task)


def objective_matches_jax(j, task):
    """compute_* in training mode (the attacked tasks with their 2-step PGD
    and the batch's swapped captions) against the JAX package's on the same
    weights and batch: the same keys; logits, losses and per-sample losses
    within RTOL x max(1, max|ref|); the discrete outputs (labels, step
    accuracies, flip rate) equal; the gradient of every parameter the loss
    reaches within RTOL x max(1, max|ref|), every other JAX gradient zero."""
    s = j(task)
    ts = _port(s)
    seeds = TT.task_seeds(s.cfg, torch.Generator().manual_seed(0), s.cfg.num_layers, B, "cpu")
    ret = _port_objective(ts, s.cfg, task, _t(s.batch), seeds=seeds[task])
    ref_ret, ref_grads = s.ret_grads
    assert set(ret) == set(ref_ret), set(ret) ^ set(ref_ret)
    for key, ref in ref_ret.items():
        if key.endswith(("_labels", "_accuracy", "_flip_rate", "_targets")):
            np.testing.assert_array_equal(ret[key].detach().numpy(), ref, err_msg=key)
        else:
            _close(key, ret[key], ref, RTOL)
    sum(ret[k] for k in _loss_keys(task)).backward()
    ours = leaves_to_jax(ts.model, grads=True)
    for path, g in ref_grads.items():
        if path in ours:
            _close(f"grad {path}", ours[path], g, RTOL)
        else:
            assert not np.any(g), path
    assert len(ours) > 20


def test_nlvr2_attacked_pass_reuses_the_clean_dropout(files):
    """At drop_rate 0.1, with the attacked text equal to the clean text and
    no PGD, compute_nlvr2_attack's attacked logits equal its original logits
    bit for bit (both passes read the same seeds, as the JAX package hands
    both the same rng), and another draw of seeds moves them."""
    tok = WordPieceTokenizer(files[0])
    cfg = _cfg(tok.vocab_size, "nlvr2_attacked", drop_rate=0.1, image_view=False)
    ts = TT.create_train_state(cfg, device="cpu")
    batch = _t(make_batch(cfg, tok, swapped=SENTENCES))
    gen = torch.Generator().manual_seed(0)
    seeds = TT.task_seeds(cfg, gen, cfg.num_layers, B, "cpu")["nlvr2_attacked"]
    assert seeds.shape == (2, cfg.num_layers + 1, 2, B)
    ret = _port_objective(ts, cfg, "nlvr2_attacked", batch, seeds=seeds)
    assert torch.equal(ret["nlvr2_attacked_logits"], ret["nlvr2_original_logits"])
    assert ret["nlvr2_flip_rate"].item() == 0.0
    other = TT.task_seeds(cfg, gen, cfg.num_layers, B, "cpu")["nlvr2_attacked"]
    again = _port_objective(ts, cfg, "nlvr2_attacked", batch, seeds=other)
    assert not torch.equal(again["nlvr2_original_logits"], ret["nlvr2_original_logits"])
    irtr = _cfg(tok.vocab_size, "irtr", drop_rate=0.1)
    assert TT.task_seeds(irtr, gen, 2, B, "cpu")["irtr"].shape == (1, 3, 2, B * (FALSE + 1))


# ------------------------------------------------------------ NLVR2 PGD
@pytest.mark.parametrize("gate", [(True, True), (False, True), (True, False)],
                         ids=["both", "image_1", "image_0"])
def test_pgd_nlvr2_matches_jax(j, gate):
    """make_pgd_nlvr2 (2 steps, the fast path) against the JAX package's on
    the same weights, batch and labels, each attack_idx gate: both deltas
    within DELTA_ATOL, the gated one exactly zero, the other moved; the
    parameters' requires_grad restored."""
    s = j("nlvr2_attacked")
    cfg = s.cfg
    b = _clean(s.batch)
    ref = jax.jit(JP.make_pgd_nlvr2(s.model, cfg.adv_steps_img, cfg.adv_lr_img,
                                    cfg.adv_max_norm_img, gate))(
        s.params, _j(b), jnp.asarray(b["answers"]))
    ts = _port(s)
    attack = make_pgd_nlvr2(ts.model, cfg.adv_steps_img, cfg.adv_lr_img,
                            cfg.adv_max_norm_img, gate)
    ours = attack(_t(b), torch.from_numpy(b["answers"]), block_matrices=ts.block_matrices)
    for i, (d, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(d.numpy(), np.asarray(r), atol=DELTA_ATOL, rtol=0,
                                   err_msg=f"delta_{i}")
        assert (d.abs().max().item() > 1e-3) == gate[i], i
    assert all(p.requires_grad for p in ts.model.parameters())


# ------------------------------------------------------------- the steps
def _close_params(ours, want, grads, cfg, what):
    """Leaves after an AdamW step (test_torch_train.py's ``_close_params``
    with the rate of each leaf's group: the heads at lr x lr_mult): 2% of
    the rate where the gradient is firm, 2.5 x the rate elsewhere.  A
    gradient element below 1e-4 of the model's largest is not firm even when
    it is its tensor's largest: rank_output's bias adds the same to every
    score of a row, which leaves IRTR's softmax as it is, so its true
    gradient is 0 and the JAX package's 3e-8 (1.6e-5 of the largest) is
    rounding, whose sign AdamW turns into a step of the whole rate."""
    top = max(np.abs(g).max() for g in grads.values())
    for path, ref in want.items():
        diff = np.abs(ours[path] - ref)
        head = any(h in path for h in TS.HEAD_NAMES)
        scale = cfg.learning_rate * (cfg.lr_mult if head else 1)
        g = np.abs(grads[path])
        firm = (g > 1e-4 * max(g.max(), 1e-30)) & (g > 1e-4 * top)
        assert diff[firm].max(initial=0.0) <= 0.02 * scale, (what, path, diff[firm].max())
        assert diff.max() <= 2.5 * scale, (what, path, diff.max())


def _check_step(cfg, grads, ts, metrics, jts, jm, what):
    assert set(metrics) == set(jm), set(metrics) ^ set(jm)
    for key, ref in jm.items():
        np.testing.assert_allclose(metrics[key].item(), float(ref), rtol=RTOL, atol=1e-6,
                                   err_msg=f"{what} {key}")
    ours, want = leaves_to_jax(ts.model), _jflat(jts.params)
    assert set(ours) == set(want)
    _close_params(ours, want, grads, cfg, what)


def _jax_step(s, batch):
    """The JAX package's make_train_step as its body composes it: the
    gradient of compute_all_tasks (here the objective's, which calls the
    same compute_*), the optimizer's update, the scalar outputs, total_loss
    and lr: (new params, metrics, gradients).  One small program per task
    (the update) where the whole step would compile the objective again."""
    (total, ret), grads = s.objective(s.params, _j(batch))
    if not hasattr(s, "update"):
        s.update = jax.jit(s.tx.update)
    updates, _ = s.update(grads, s.ts.opt_state, s.params)
    metrics = {k: v for k, v in ret.items() if np.ndim(v) == 0}
    metrics.update(total_loss=total, lr=JS.make_lr_schedule(s.cfg, s.cfg.max_steps)(0))
    return _jflat(optax.apply_updates(s.params, updates)), metrics, _jflat(grads)


def _check_step(cfg, ts, metrics, want, jm, grads, what):
    assert set(metrics) == set(jm), set(metrics) ^ set(jm)
    for key, ref in jm.items():
        np.testing.assert_allclose(metrics[key].item(), float(ref), rtol=RTOL, atol=1e-6,
                                   err_msg=f"{what} {key}")
    ours = leaves_to_jax(ts.model)
    assert set(ours) == set(want)
    _close_params(ours, want, grads, cfg, what)


@pytest.mark.parametrize("task", CLEAN)
def test_train_step_matches_jax(j, task):
    """The clean tasks' make_train_step (``train_step_matches_jax``)."""
    train_step_matches_jax(j, task)


def train_step_matches_jax(j, task):
    """make_train_step (the attacked tasks with the batch's swapped captions
    as the text view and 2-step PGD) against the JAX package's step on the
    same weights and batch (``_jax_step``): every metric within RTOL, lr
    equal, every parameter after AdamW (the heads at lr x lr_mult)."""
    s = j(task)
    want, jm, grads = _jax_step(s, s.batch)
    ts = _port(s)
    metrics = TT.make_train_step(s.cfg, ts)(_t(s.batch), torch.Generator().manual_seed(0))
    _check_step(s.cfg, ts, metrics, want, jm, grads, task)
    assert ts.step == 1
