"""The port's downstream evaluation and training entry point against the JAX
package on the CPU in fp32 (tests/test_torch_downstream.py's model sizes):

  * recall_at_k on scores with ties, exactly; the VQA submission file byte
    for byte, and vqa_accuracy; the answer glossary copy against its
    original; the NLVR2 and IRTR weights carried across and back unchanged;
  * the Trainer for task_finetune_irtr_coco (validate with the recall metric,
    then fit and its validation) and task_finetune_vqa_randaug_attacked (fit,
    then validate on the test split with the submission writer) against the
    JAX package's Trainer on the same weights and arrow tables: before
    training the recall's score matrix within 1e-5 x max(1, max|ref|) and the
    recall itself equal; the steps' total_loss within 1e-5 relative (lr
    equal); after training the epoch metrics within 2e-3 relative (the
    parameters differ by up to AdamW's 2% of the rate) and the submission
    file byte for byte;
  * the attacked recall (greedy IRTR text attack, IRTR PGD on each image)
    against the JAX package's on the same weights: score matrix and recall
    as above;
  * ``cli.run with`` the three named configurations on the CPU."""

import io
import json
import os

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
from PIL import Image

from rmcl_tpu.core.config import build_config as jax_build_config
from rmcl_tpu.data import vqa_glossary as JGloss
from rmcl_tpu.eval import retrieval as JR
from rmcl_tpu.eval import vqa as JV
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.train.loop import Trainer as JaxTrainer
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
from rmcl_tpu_torch.core.config import build_config, loss_names
from rmcl_tpu_torch.data import vqa_glossary as TGloss
from rmcl_tpu_torch.data.tokenizer import get_tokenizer, make_tiny_vocab
from rmcl_tpu_torch.eval import retrieval as TR
from rmcl_tpu_torch.eval import vqa as TV
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.train import loop as TL
from tests.test_attacks import SYN_GROUPS
from tests.test_torch_downstream import _moved
from tests.test_torch_greedy import _write_vectors
from tests.test_torch_train import _close, _jflat, _port_of
from tests._torch_threads import one_thread  # noqa: F401

WORDS = ["dog", "puppy", "cat", "kitten", "red", "crimson", "big", "large", "runs",
         "sprints", "park", "garden", "street", "road", "is", "what", "the", "a", "in",
         "on", "yes", "no", "two"]
CAPTIONS = ["dog runs in park", "the red cat", "big dog on street", "cat runs in garden",
            "red puppy in the road", "large kitten"]
QUESTIONS = ["is the dog red", "what runs in the park", "is the cat big",
             "what is on the street"]
ANSWERS = [["yes", "no"], ["dog"], ["two", "yes"], ["cat"]]


def _png(seed, hw=(36, 48)):
    img = Image.fromarray(np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _write(path, rows):
    table = pa.table(rows)
    with pa.OSFile(path, "wb") as f:
        with pa.RecordBatchFileWriter(f, table.schema) as w:
            w.write_table(table)


def write_tables(d):
    """coco karpathy train / test (one caption per image), vqav2 train / val
    (two questions per image, soft answers) and nlvr2 train / dev / test1."""
    for name, n, off in (("coco_caption_karpathy_train", 4, 0),
                         ("coco_caption_karpathy_test", 3, 40)):
        _write(os.path.join(d, f"{name}.arrow"), {
            "image": [_png(off + i, (36 + 4 * (i % 3), 48)) for i in range(n)],
            "caption": [[CAPTIONS[(off + i) % len(CAPTIONS)]] for i in range(n)],
            "image_id": [f"{off + i}.jpg" for i in range(n)], "split": ["train"] * n})
    for name, n, off in (("vqav2_train", 2, 60), ("vqav2_val", 2, 70)):
        qs = [[QUESTIONS[(2 * i + k) % 4] for k in range(2)] for i in range(n)]
        ans = [[ANSWERS[(2 * i + k) % 4] for k in range(2)] for i in range(n)]
        labels = {a: i for i, a in enumerate(sorted({x for a in ANSWERS for x in a}))}
        _write(os.path.join(d, f"{name}.arrow"), {
            "image": [_png(off + i) for i in range(n)], "questions": qs, "answers": ans,
            "answer_labels": [[[labels[x] for x in a] for a in row] for row in ans],
            "answer_scores": [[[1.0, 0.3][:len(a)] for a in row] for row in ans],
            "question_id": [[off * 10 + 2 * i + k for k in range(2)] for i in range(n)],
            "split": ["x"] * n})
    for name, n, off in (("nlvr2_train", 4, 80), ("nlvr2_dev", 2, 90), ("nlvr2_test1", 2, 95)):
        _write(os.path.join(d, f"{name}.arrow"), {
            "image_0": [_png(off + i) for i in range(n)],
            "image_1": [_png(off + 50 + i, (40, 44)) for i in range(n)],
            "questions": [[CAPTIONS[(off + i) % len(CAPTIONS)]] for i in range(n)],
            "answers": [["True" if (off + i) % 2 else "False"] for i in range(n)],
            "identifier": [f"{name}-{i}" for i in range(n)]})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("downstream_eval")
    write_tables(str(d))
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    return str(d), vocab, _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)


def _kw(d, vocab, **kw):
    base = dict(data_root=d, tokenizer=vocab, hidden_size=32, num_heads=4, num_layers=2,
                patch_size=16, image_size=32, image_bucket_hw=(32, 48), max_text_len=12,
                vocab_size=get_tokenizer(vocab).vocab_size, vqav2_label_size=8,
                draw_false_text=3, use_pallas_attention=False, compute_dtype="float32",
                drop_rate=0.0, learning_rate=1e-3, warmup_steps=0, batch_size=2, max_epoch=1,
                num_workers=0, log_every_n_steps=1, sim_path="", adv_steps_img=1)
    base.update(kw)
    return base


# ------------------------------------------------------------ unit parts
def test_recall_at_k_matches_jax():
    """recall_at_k on integer scores full of ties (the lower index ranks
    first, as lax.top_k orders them) and on continuous scores: the six
    recalls equal the JAX package's exactly."""
    r = np.random.RandomState(0)
    iids = np.arange(12)
    tiids = r.randint(0, 12, 40)
    for scores in (r.randint(0, 3, (12, 40)).astype(np.float32),
                   r.randn(12, 40).astype(np.float32)):
        assert TR.recall_at_k(scores, iids, tiids) == JR.recall_at_k(scores, iids, tiids)


def test_vqa_writer_and_accuracy_match_jax(tmp_path):
    """VQASubmissionWriter on the same logits, question ids and answer table
    (a defaultdict: unknown ids answer "unknown") writes the JAX package's
    file byte for byte, and so does its merge of two processes' parts
    (without a gather, more than one process raises); vqa_accuracy equals
    the JAX package's on annotations that exercise the normalisation."""
    from collections import defaultdict
    r = np.random.RandomState(1)
    id2answer = defaultdict(lambda: "unknown", {0: "yes", 1: "two", 2: "red dog"})
    logits = [r.randn(4, 5).astype(np.float32) for _ in range(3)]
    files = []
    for mod, out in ((JV, "jax"), (TV, "port")):
        w = mod.VQASubmissionWriter(id2answer, out_dir=str(tmp_path / out), model_name="m")
        for s, x in enumerate(logits):
            w.update(list(range(10 * s, 10 * s + 4)), x)
        files.append(w.finalize())
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()
    # two processes: rank 0 writes the parts merged in the loader's order
    # (rank r holds the samples r, r + 2, ...), here the one-process file
    parts = []
    for rank in range(2):
        w = TV.VQASubmissionWriter(id2answer, out_dir=str(tmp_path / "ranks"), model_name="m")
        for s, x in enumerate(logits):
            w.update(list(range(10 * s, 10 * s + 4))[rank::2], x[rank::2])
        parts.append(w)
    rets = [[{"question_id": q, "answer": id2answer[int(p)]} for q, p in zip(w.qids, w.preds)]
            for w in parts]
    assert parts[1].finalize(process_index=1, process_count=2, gather=lambda _: rets) is None
    merged = parts[0].finalize(process_index=0, process_count=2, gather=lambda _: rets)
    with open(files[0], "rb") as a, open(merged, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="gather"):
        TV.VQASubmissionWriter(id2answer).finalize(process_index=0, process_count=2)
    preds = {1: "Two", 2: "a dog", 3: "yes!", 4: "no"}
    anns = [{"question_id": q, "answer_type": t, "answers": [{"answer": a} for a in ans]}
            for q, t, ans in ((1, "number", ["2", "two", "2", "3"] * 3),
                              (2, "other", ["dog", "the dog", "dogs"] * 3),
                              (3, "yes/no", ["yes"] * 10), (4, "yes/no", ["yes"] * 10))]
    assert TV.vqa_accuracy(preds, anns) == JV.vqa_accuracy(preds, anns)


def test_glossary_copy_matches_the_original():
    """data/vqa_glossary.py: the tables and the code below the docstring are
    the JAX package's, and the three functions agree on tricky answers."""
    def body(mod):
        src = open(mod.__file__).read()
        return src[src.index('"""', 3) + 3:]
    assert body(TGloss) == body(JGloss)
    for a in ["Two dogs!", "it's a man's world", "dont know", "ten. ", "a, b; c", "1,000"]:
        for f in ("normalize_word", "process_digit_article", "process_punctuation"):
            if hasattr(JGloss, f):
                assert getattr(TGloss, f)(a) == getattr(JGloss, f)(a), (f, a)


@pytest.mark.parametrize("task", ["nlvr2", "irtr"])
def test_weights_carry_across_and_back(data, task):
    """The JAX package's NLVR2 weights (nlvr2_classifier on 2C features, the
    three-row token-type table) and IRTR weights (rank_output, itm_score)
    load into the port's ViLT and come back from leaves_to_jax unchanged."""
    kw = _kw(data[0], data[1], loss_names=loss_names({task: 1}))
    cfg = build_config(**kw)
    params, state = init_vilt(jax.random.PRNGKey(2), jax_build_config(**kw))
    params = _moved(params)
    model = _port_of(cfg, params, state)
    ours, want = leaves_to_jax(model), _jflat(params)
    assert set(ours) == set(want)
    assert all(np.array_equal(ours[k], want[k]) for k in want)
    if task == "nlvr2":
        assert model.nlvr2_classifier["0"].weight.shape == (64, 64)
        assert model.token_type_embeddings.weight.shape[0] == 3
    else:
        assert model.rank_output.weight.shape == (1, 32) and hasattr(model, "itm_score")


# ------------------------------------------------------- the Trainers
def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _capture(monkeypatch, mod):
    """recall_at_k of ``mod`` keeps the score matrix it ranks."""
    seen, inner = [], mod.recall_at_k

    def recall_at_k(scores, iids, tiids):
        seen.append(np.asarray(scores).copy())
        return inner(scores, iids, tiids)

    monkeypatch.setattr(mod, "recall_at_k", recall_at_k)
    return seen


def _trainers(data, tmp_path, config, **kw):
    d, vocab, _ = data
    args = _kw(d, vocab, **kw)
    jcfg = jax_build_config(config, log_dir=str(tmp_path / "jax"), **args)
    params, state = init_vilt(jax.random.PRNGKey(0), jcfg)
    params = _moved(params)
    jtr = JaxTrainer(jcfg, workdir=jcfg.log_dir, use_mesh=False)
    jtr.setup(params=params, state=state)
    cfg = build_config(config, log_dir=str(tmp_path / "port"), **args)
    tr = TL.Trainer(cfg, workdir=cfg.log_dir, device="cpu")
    tr.setup(model=_port_of(cfg, params, state))
    return jtr, tr


def _same_steps(ours, ref):
    steps = [r for r in ours if "train/total_loss" in r]
    jsteps = [r for r in ref if "train/total_loss" in r]
    assert [r["step"] for r in steps] == [r["step"] for r in jsteps] and steps
    for a, b in zip(steps, jsteps):
        np.testing.assert_allclose(a["train/total_loss"], b["train/total_loss"], rtol=1e-5)
        assert a["train/lr"] == pytest.approx(b["train/lr"], rel=1e-6)


def _same_epoch(ours, ref, rtol):
    a = [r for r in ours if any(k.startswith("val_epoch/") for k in r)]
    b = [r for r in ref if any(k.startswith("val_epoch/") for k in r)]
    assert len(a) == len(b) == 1
    keys = {k for k in b[0] if k.startswith("val_epoch/")}
    assert keys == {k for k in a[0] if k.startswith("val_epoch/")}
    for k in keys:
        np.testing.assert_allclose(a[0][k], b[0][k], rtol=rtol, atol=1e-6, err_msg=k)
    return a[0]


def test_irtr_trainer_matches_the_jax_trainer(data, tmp_path, monkeypatch):
    """task_finetune_irtr_coco (draw_false_text 3, batch 2): validate("test")
    before training, with the recall metric over the 3 test images and
    their captions (score matrix within 1e-5 x max(1, max|ref|), recall and
    irtr accuracy equal); then fit, one epoch of 2 steps, with its
    validation and recall: the steps and the epoch metrics as the module
    docstring says, the recall keys among them."""
    jtr, tr = _trainers(data, tmp_path, "task_finetune_irtr_coco")
    jseen, seen = _capture(monkeypatch, JR), _capture(monkeypatch, TR)
    jv, v = jtr.validate("test"), tr.validate("test")
    _close("recall scores", seen[0], jseen[0], 1e-5)
    assert seen[0].shape == (3, 3) and np.ptp(seen[0]) > 0
    assert {k: v[k] for k in jv} == pytest.approx(jv, rel=1e-5, abs=1e-6)
    for k in ("ir_r1", "ir_r5", "ir_r10", "tr_r1", "tr_r5", "tr_r10"):
        assert v[k] == jv[k], k
    jtr.fit()
    tr.fit()
    ours, ref = _records(tr.workdir), _records(jtr.workdir)
    _same_steps(ours, ref)
    epoch = _same_epoch(ours, ref, 2e-3)
    assert "val_epoch/ir_r1" in epoch and len(seen) == len(jseen) == 2


def test_vqa_attacked_trainer_matches_the_jax_trainer(data, tmp_path):
    """task_finetune_vqa_randaug_attacked with the image view (1 PGD step;
    the text view's attacked step is held in
    tests/test_torch_downstream_attacked.py): fit, one epoch of 2 steps,
    and its validation as the module docstring says; then validate("test")
    writes the submission file, byte for byte the JAX Trainer's."""
    jtr, tr = _trainers(data, tmp_path, "task_finetune_vqa_randaug_attacked",
                        image_view=True, vqav2_label_size=len(
                            {x for a in ANSWERS for x in a}))
    jtr.fit()
    tr.fit()
    ours, ref = _records(tr.workdir), _records(jtr.workdir)
    _same_steps(ours, ref)
    _same_epoch(ours, ref, 2e-3)
    jtr.validate("test")
    tr.validate("test")
    name = "vqa_submit_finetune_vqa_randaug_attacked.json"
    with open(os.path.join(jtr.cfg.log_dir, name), "rb") as a, \
            open(os.path.join(tr.cfg.log_dir, name), "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and len(json.loads(got)) == 4


def test_model_state_dict_names_the_skipped_heads(data):
    """load_reference_state_dict returns the entries of heads this model
    does not build (an MPP head among them)."""
    cfg = build_config(**_kw(data[0], data[1], loss_names=loss_names({"vqa": 1})))
    model = ViLT(cfg)
    sd = dict(model.state_dict(), **{"mpp_score.decoder.weight": torch.zeros(3, 32)})
    assert model.load_reference_state_dict(sd) == ["mpp_score.decoder.weight"]
