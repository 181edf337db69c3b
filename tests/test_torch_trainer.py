"""The port's training entry point (rmcl_tpu_torch/train/loop.py:Trainer,
train/checkpoint.py, train/logging.py,
cli/run.py's ``with`` form) on the CPU at
a tiny size (2 layers, C = 32, queue 16 x 128, the arrow tables of
tests/test_torch_data.py's kind).

  * the Trainer against the JAX package's Trainer on the same weights and
    tables (image view, one PGD step, drop_rate 0, warmup 0; 2 epochs of 2
    steps): per-step total_loss and lr within test_torch_train's
    two-step tolerances, the epoch metrics of the two metrics.jsonl files,
    and the final parameters read from the port's ``last`` checkpoint through
    the JAX package's ``convert_state_dict`` within ``_close_params``' bounds;
  * the attacked Trainer (fused greedy attack, accum 2) against the port's
    own ``make_attacked_train_step`` driven by hand on the loader's batches
    with the same generators: bit for bit (that step is held against the JAX
    package in tests/test_torch_greedy.py);
  * preemption and resume bit for bit, and the checkpoint pointer's
    crash safety and per-process temporary name;
  * the command line.
"""

import io
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from PIL import Image

from rmcl_tpu.compat.torch_loader import convert_state_dict
from rmcl_tpu.core.config import build_config as jax_build_config
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.train import step as JT
from rmcl_tpu.train.loop import Trainer as JaxTrainer
from rmcl_tpu_torch.attacks.greedy import GreedyAttackMoco, SynonymTable
from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
from rmcl_tpu_torch.core.config import build_config
from rmcl_tpu_torch.data.tokenizer import get_tokenizer, make_tiny_vocab
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.train import checkpoint as CK
from rmcl_tpu_torch.train import loop as TL
from rmcl_tpu_torch.train import step as TT
from tests.test_attacks import SYN_GROUPS
from tests.test_attacks import WORDS as GREEDY_WORDS
from tests.test_torch_greedy import _write_vectors
from tests.test_torch_train import _cfg, _close_params, _jflat, _perturbed, _port_of
from tests._torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["dog", "running", "park", "the", "red", "cat", "sits"]
CAPTIONS = ["a dog running in the park", "the red cat sits", "dog in the park",
            "a cat running", "the dog sits in the red park", "red dog"]


def _png(seed):
    img = Image.fromarray(np.random.RandomState(seed).randint(
        0, 256, (36 + 4 * (seed % 3), 48, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def write_tables(d, captions, n_train, n_test):
    """coco karpathy train and test tables, one caption per image."""
    for name, n, off in (("coco_caption_karpathy_train", n_train, 0),
                         ("coco_caption_karpathy_test", n_test, 40)):
        table = pa.table({
            "image": [_png(off + i) for i in range(n)],
            "caption": [[captions[(off + i) % len(captions)]] for i in range(n)],
            "image_id": [f"{off + i}.jpg" for i in range(n)], "split": ["train"] * n})
        with pa.OSFile(os.path.join(d, f"{name}.arrow"), "wb") as f:
            with pa.RecordBatchFileWriter(f, table.schema) as w:
                w.write_table(table)


def _kw(d, vocab, **kw):
    """The tiny task_moco run: tests/test_torch_train.py's model, the
    tables under ``d``."""
    base = dict(datasets=("coco",), data_root=d, tokenizer=vocab, hidden_size=32,
                num_heads=2, num_layers=2, patch_size=16, image_size=32,
                image_bucket_hw=(32, 48), max_text_len=12, vocab_size=64, num_negative=16,
                momentum=0.99, temperature=0.07, use_pallas_attention=False,
                compute_dtype="float32", drop_rate=0.0, max_image_len=4, image_view=True,
                text_view=False, adv_steps_img=1, adv_lr_img=0.05, adv_max_norm_img=0.005,
                learning_rate=1e-3, weight_decay=0.01, lr_mult=10, max_steps=100,
                warmup_steps=0, batch_size=4, max_epoch=2, num_workers=2,
                log_every_n_steps=1, sim_path="")
    base.update(kw)
    return base


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _steps(records):
    return [r for r in records if "train/total_loss" in r]


# ------------------------------------------------- against the JAX Trainer
@pytest.fixture(scope="module")
def vs_jax(tmp_path_factory):
    """The JAX package's Trainer over 2 epochs of 2 steps, once: its config,
    initial params, records, final params and state, and its gradient at
    the first batch (which elements of a leaf are firm: _close_params)."""
    d = tmp_path_factory.mktemp("trainer_vs_jax")
    write_tables(str(d), CAPTIONS, n_train=8, n_test=6)
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    kw = _kw(str(d), vocab)
    jcfg = jax_build_config("task_moco", log_dir=str(d / "jax"), **kw)
    params, state = init_vilt(jax.random.PRNGKey(0), jcfg)
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    params, state = jax.tree.map(np.array, (params, state))   # the step donates its input
    tr = JaxTrainer(jcfg, workdir=jcfg.log_dir, use_mesh=False)
    tr.setup(params=jax.tree.map(jnp.array, params), state=jax.tree.map(jnp.array, state))
    first = next(iter(tr.dm.train_loader(tr.per_host_batch)))
    jb = {k: jnp.asarray(v) for k, v in first.items()
          if isinstance(v, np.ndarray) and not k.startswith("_")}
    grads = _jflat(jax.jit(jax.grad(lambda p: JT.compute_all_tasks(
        jcfg, tr.model, p, tr.ts.state, jb, jax.random.PRNGKey(0), train=True)[0]))(
            tr.ts.params))
    tr.fit()
    return dict(d=str(d), vocab=vocab, kw=kw, params=params, state=state,
                records=_records(tr.workdir), final={**_jflat(tr.ts.params),
                                                     **_jflat(tr.ts.state)},
                grads={p: g for p, g in grads.items() if not p.startswith("k_")})


def _close_twins(ours, want, grads, lr, m, steps):
    """The momentum twins after ``steps`` steps.  A twin moves by (1 - m)
    times its query parameter's distance, so it inherits (1 - m) of each
    step's query difference, which _close_params bounds by 2% of the rate
    where the gradient is firm and 2.5 times the rate elsewhere: the twin is
    held to ``steps`` times (1 - m) of those bounds, plus 1e-6."""
    for path in (p for p in want if p.startswith("k_")):
        diff = np.abs(ours[path] - want[path])
        scale = lr * (10 if "moco_head" in path else 1) * (1 - m) * steps
        g = np.abs(grads.get(path[2:], np.zeros_like(diff)))
        firm = g > 1e-4 * max(g.max(), 1e-30)
        assert diff[firm].max(initial=0.0) <= 0.02 * scale + 1e-6, (path, diff[firm].max())
        assert diff.max() <= 2.5 * scale + 1e-6, (path, diff.max())


def test_trainer_matches_the_jax_trainer(vs_jax, tmp_path):
    kw = vs_jax["kw"]
    cfg = build_config("task_moco", log_dir=str(tmp_path), **kw)
    tr = TL.Trainer(cfg, workdir=cfg.log_dir, device="cpu")
    tr.setup(model=_port_of(cfg, vs_jax["params"], vs_jax["state"]))
    assert (tr.steps_per_epoch, tr.accum_steps, tr.max_steps) == (2, 1, 100)
    tr.fit()
    ours, ref = _records(tr.workdir), vs_jax["records"]
    steps, jsteps = _steps(ours), _steps(ref)
    assert [r["step"] for r in steps] == [r["step"] for r in jsteps] == [1, 2, 3, 4]
    for i, (a, b) in enumerate(zip(steps, jsteps)):
        for key in ("train/total_loss", "train/lr"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4 if i == 0 else 2e-3,
                                       atol=1e-5, err_msg=f"step {i + 1} {key}")
    for prefix in ("train_epoch/", "val_epoch/"):
        a = [r for r in ours if any(k.startswith(prefix) for k in r)]
        b = [r for r in ref if any(k.startswith(prefix) for k in r)]
        assert len(a) == len(b) == 2, prefix
        for ra, rb in zip(a, b):
            keys = {k for k in rb if k.startswith(prefix)}
            assert keys == {k for k in ra if k.startswith(prefix)}, prefix
            for k in keys:
                np.testing.assert_allclose(ra[k], rb[k], rtol=2e-3, atol=1e-5, err_msg=k)
    # the final parameters from the port's checkpoint, through the JAX
    # package's converter
    sd = torch.load(os.path.join(tr.ckpt.checkpoint_dir("last"), CK.MODEL_FILE),
                    weights_only=True)["state_dict"]
    params, state = convert_state_dict(sd, cfg)
    ours, want = {**_jflat(params), **_jflat(state)}, vs_jax["final"]
    assert set(ours) == set(want)
    twins = {p for p in want if p.startswith("k_")}
    _close_params({p: v for p, v in ours.items() if p not in twins},
                  {p: v for p, v in want.items() if p not in twins}, vs_jax["grads"],
                  1e-3, "after 4 steps")
    _close_twins(ours, want, vs_jax["grads"], 1e-3, cfg.momentum, 4)
    assert tr.ckpt.has("best") and tr.host_reads == 4   # one per log interval (1 step)


# ------------------------------------------------------ the attacked Trainer
def test_attacked_trainer_matches_the_attacked_step_by_hand(tmp_path):
    """Fused greedy attack inside the step, both views, drop_rate 0.1, accum
    2 (batch_size 4, 2 pairs per step), one epoch of 4 micro-steps: the
    Trainer's per-step metrics and final parameters, buffers included, equal
    those of make_attacked_train_step driven by hand on the same loader's
    batches with step_generator's generators."""
    d = str(tmp_path)
    sents = ["dog runs in park", "cat sits in street", "big red car on road",
             "the a on in", "dog sits", "cat runs on road", "red dog in park", "big cat"]
    write_tables(d, sents, n_train=8, n_test=2)
    vocab = make_tiny_vocab(os.path.join(d, "vocab.txt"), GREEDY_WORDS)
    vectors = _write_vectors(os.path.join(d, "vectors.txt"), SYN_GROUPS, GREEDY_WORDS)
    cfg = build_config("task_moco", **_kw(
        d, vocab, text_view=True, drop_rate=0.1, per_device_batchsize=2, max_epoch=1,
        n_candidates=3, max_loops=2, embedding_path=vectors, log_dir=os.path.join(d, "out"),
        vocab_size=get_tokenizer(vocab).vocab_size))
    model = ViLT(cfg).init(torch.Generator().manual_seed(cfg.seed))
    twin = ViLT(cfg)
    twin.load_state_dict(model.state_dict())

    tr = TL.Trainer(cfg, workdir=cfg.log_dir, device="cpu")
    tr.setup(model=model)
    assert isinstance(tr.greedy, FusedGreedyAttack) and tr.accum_steps == 2
    tr.fit()
    steps = _steps(_records(tr.workdir))
    assert len(steps) == 4

    ts = TT.create_train_state(cfg, max_steps=tr.max_steps, model=twin, device="cpu",
                               accum=2)
    greedy = FusedGreedyAttack(GreedyAttackMoco(
        cfg, twin, get_tokenizer(vocab), SynonymTable(vectors, 3, cfg.sim_thred)))
    step = TT.make_attacked_train_step(cfg, ts, greedy, max_steps=tr.max_steps)
    loader = tr.dm.train_loader(2)
    loader.set_epoch(0)
    for i, batch in enumerate(loader):
        batch = dict(batch, **greedy.prep_tables(batch["text_ids"]))
        metrics = step(TL._device_batch(batch, torch.device("cpu")),
                       TL.step_generator(cfg.seed + 1, i))
        want = {f"train/{k}": v.item() for k, v in metrics.items()}
        assert want == {k: v for k, v in steps[i].items() if k.startswith("train/")}, i
    assert i == 3 and steps[-1]["train/num_changes"] > 0
    ours, ref = tr.ts.model.state_dict(), ts.model.state_dict()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


# ------------------------------------------------- preemption and resume
@pytest.fixture(scope="module")
def resume_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    write_tables(str(d), CAPTIONS, n_train=6, n_test=2)
    return str(d), make_tiny_vocab(str(d / "vocab.txt"), WORDS)


def _resume_trainer(resume_data, workdir, **kw):
    """2 pairs per step, accum 2 (batch_size 4), drop_rate 0.1, 3 micro-steps
    per epoch, 2 epochs: 6 micro-steps, 3 optimizer steps."""
    d, vocab = resume_data
    cfg = build_config("task_moco", **_kw(d, vocab, drop_rate=0.1, per_device_batchsize=2,
                                          max_steps=3, log_dir=workdir, **kw))
    tr = TL.Trainer(cfg, workdir=workdir, device="cpu")
    tr.setup()
    seen = []
    inner = tr.step_fn

    def step_fn(db, gen):
        seen.append(db["text_ids"].clone())
        return inner(db, gen)

    tr.step_fn = step_fn
    return tr, seen


@pytest.mark.parametrize("at", [3, 5], ids=["epoch_end_mid_cycle", "mid_epoch_mid_cycle"])
def test_preempt_and_resume_reproduce_the_straight_run(resume_data, tmp_path, at):
    """The straight run against a run preempted after micro-step ``at``
    (request_preemption; a mid-cycle accumulated gradient in its ``last``)
    and resumed by a new Trainer with resume_from: the same batches in the
    same order (the second epoch skips the batches already trained), the
    same per-step losses and every parameter and buffer equal; the best
    score comes back with ``last``, so ``best`` ends where the straight
    run's does."""
    straight, seen_a = _resume_trainer(resume_data, str(tmp_path / "a"))
    assert (straight.steps_per_epoch, straight.accum_steps) == (3, 2)
    straight.fit()
    assert straight.steps_done == 6

    first, seen_b = _resume_trainer(resume_data, str(tmp_path / "b"))
    inner = first.step_fn

    def preempting(db, gen):
        out = inner(db, gen)
        if len(seen_b) == at:
            first.request_preemption()
        return out

    first.step_fn = preempting
    first.fit()
    assert first.steps_done == at and first.ckpt.has("last")
    second, seen_c = _resume_trainer(resume_data, str(tmp_path / "b"), resume_from="last")
    assert second.steps_done == at and second.ts.step == at
    assert second.ckpt.best_score == first.ckpt.best_score
    assert (first.ckpt.best_score is None) == (at <= straight.steps_per_epoch)
    second.fit()
    assert second.steps_done == 6
    assert len(seen_a) == len(seen_b) + len(seen_c) == 6
    assert all(torch.equal(x, y) for x, y in zip(seen_a, seen_b + seen_c))
    loss = lambda tr: [r["train/total_loss"] for r in _steps(_records(tr.workdir))]  # noqa: E731
    assert loss(straight) == loss(second) and len(loss(straight)) == 6
    a, b = straight.ts.model.state_dict(), second.ts.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert straight.ts.scheduler.last_epoch == second.ts.scheduler.last_epoch == 3
    best_step = lambda tr: torch.load(  # noqa: E731
        os.path.join(tr.ckpt.checkpoint_dir("best"), CK.TRAIN_FILE), weights_only=True)["step"]
    assert second.ckpt.best_score == straight.ckpt.best_score
    assert best_step(second) == best_step(straight)


def _tiny_state(seed=0):
    cfg = _cfg()
    model = ViLT(cfg).init(torch.Generator().manual_seed(seed))
    return TT.create_train_state(cfg, model=model, device="cpu")


def test_pointer_survives_a_crash_between_save_and_swing(tmp_path, monkeypatch):
    """A save whose pointer swing fails leaves the previous checkpoint
    reachable and restorable; a fresh manager then saves past the orphan."""
    a, b = _tiny_state(0), _tiny_state(1)
    a.step, b.step = 3, 7
    m = CK.CheckpointManager(str(tmp_path))
    m.save_last(a)
    good = m.checkpoint_dir("last")

    def crash(*args):
        raise OSError("killed before the swing")

    monkeypatch.setattr(m, "_write_ptr", crash)
    with pytest.raises(OSError):
        m.save_last(b)
    assert m.checkpoint_dir("last") == good and len(os.listdir(tmp_path)) == 3  # + orphan
    c = _tiny_state(2)
    CK.CheckpointManager(str(tmp_path)).restore(c, "last")
    assert c.step == 3 and all(torch.equal(x, y) for x, y in
                               zip(c.model.state_dict().values(),
                                   a.model.state_dict().values()))
    m2 = CK.CheckpointManager(str(tmp_path))
    m2.save_last(b)
    assert m2.checkpoint_dir("last") != good and not os.path.exists(good)
    assert m2.restore(_tiny_state(2), "last").step == 7


def test_load_path_follows_the_pointer(tmp_path):
    """load_initial_params (the Trainer's and ``cli.run serve``'s load_path)
    takes a checkpoint directory, the workdir or its logical ``last`` through
    the pointer, and a plain state-dict file: the saved model each time."""
    a = _tiny_state(0)
    CK.CheckpointManager(str(tmp_path)).save_last(a)
    d = CK.resolve_checkpoint_dir(str(tmp_path))
    assert d and os.path.basename(d).startswith("last.")
    want = a.model.state_dict()
    for path in (str(tmp_path), str(tmp_path / "last"), d, os.path.join(d, CK.MODEL_FILE)):
        model = CK.load_initial_params(_cfg(load_path=path), ViLT(_cfg()))
        got = model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), path
    assert CK.resolve_checkpoint_dir(str(tmp_path / "best")) is None


def test_two_managers_in_turn_from_two_threads_do_not_collide(tmp_path, monkeypatch):
    """Two CheckpointManagers in one workdir save 'last' in turn from two
    threads, the pointer's rename slowed so that the writes overlap: each
    writer renames its own temporary file (the JAX package's shared
    ``LAST.ptr.tmp`` makes the second rename fail), and the pointer ends on a
    checkpoint that restores."""
    real_replace = os.replace
    tmps = []

    def slow_replace(src, dst):
        if str(src).endswith(".tmp"):
            tmps.append(os.path.basename(src))
            threading.Event().wait(0.02)
        return real_replace(src, dst)

    monkeypatch.setattr(CK.os, "replace", slow_replace)
    states = [_tiny_state(0), _tiny_state(1)]
    managers = [CK.CheckpointManager(str(tmp_path)) for _ in states]
    barrier, errors = threading.Barrier(2), []

    def run(i):
        try:
            for k in range(4):
                states[i].step = 10 * i + k
                barrier.wait()
                managers[i].save_last(states[i])
        except Exception as e:  # noqa: BLE001  collected for the assert below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(tmps) == 8 and len(set(tmps)) == 2
    assert all(f".{os.getpid()}-" in t for t in tmps)
    restored = managers[0].restore(_tiny_state(2), "last")
    assert restored.step in (3, 13)


# ---------------------------------------------------------------- the CLI
def test_cli_trains_on_the_cpu_when_asked(resume_data, tmp_path):
    d, vocab = resume_data
    args = ["with", "task_moco", "fast_dev_run=True", f"data_root={d}", f"tokenizer={vocab}",
            "hidden_size=32", "num_heads=2", "num_layers=2", "patch_size=16",
            "image_size=32", "image_bucket_hw=(32,48)", "max_text_len=12", "vocab_size=64",
            "num_negative=16", "max_image_len=4", "compute_dtype=float32", "drop_rate=0.0",
            "image_view=True", "adv_steps_img=1", "batch_size=2", "num_workers=2",
            f"log_dir={tmp_path}"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # one intra-op thread, as tests/_torch_threads.py
    run = lambda extra: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "rmcl_tpu_torch.cli.run", *args, *extra], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    p = run(["device=cpu"])
    assert p.returncode == 0, p.stderr
    assert "val/the_metric" in p.stdout
    assert os.path.isfile(tmp_path / "moco" / "metrics.jsonl")
    assert os.path.isfile(tmp_path / "moco" / "LAST.ptr")
    if not torch.cuda.is_available():
        p = run([])
        assert p.returncode != 0 and "no CUDA device" in p.stderr
