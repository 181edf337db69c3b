"""The port's loader (rmcl_tpu_torch/data: rng, transforms with RandAugment,
mlm, arrow_dataset, datasets, loader, datamodule) and its metric bag
(eval/metrics.py) against the JAX package's, on the CPU: the same arrow
tables, configs and seeds give the same batches, key for key and bit for bit
(np.array_equal), and the same epoch metrics.  And the modules the Trainer
needs import with pyarrow and PIL blocked, pulling in neither jax nor
rmcl_tpu."""

import io
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
from PIL import Image

from rmcl_tpu.core.config import build_config as jax_build_config
from rmcl_tpu.data import datamodule as JDM
from rmcl_tpu.data import datasets as JD
from rmcl_tpu.data import mlm as JM
from rmcl_tpu.data import rng as JR
from rmcl_tpu.data import transforms as JT
from rmcl_tpu.eval import metrics as JMet
from rmcl_tpu_torch.core.config import build_config, loss_names
from rmcl_tpu_torch.data import datamodule as TDM
from rmcl_tpu_torch.data import datasets as TD
from rmcl_tpu_torch.data import mlm as TM
from rmcl_tpu_torch.data import rng as TR
from rmcl_tpu_torch.data import transforms as TT
from rmcl_tpu_torch.data.tokenizer import get_tokenizer, make_tiny_vocab
from rmcl_tpu_torch.eval import metrics as TMet
from tests._torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["dog", "cat", "running", "jumping", "park", "small", "big", "the", "quick"]
CAPTIONS = ["a dog running in the park", "the quick cat", "small dog jumping",
            "big cat in the park", "the dog", "running cat jumping in the quick park"]


def _png(seed, hw):
    img = Image.fromarray(np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _write(path, rows):
    table = pa.table(rows)
    with pa.OSFile(path, "wb") as f:
        with pa.RecordBatchFileWriter(f, table.schema) as w:
            w.write_table(table)


def write_caption_tables(d, n_train=7, n_test=5):
    """coco karpathy train (several captions per image, images of several
    sizes) and test tables, as tests/test_data.py's arrow_dir writes them."""
    for name, n, off in (("coco_caption_karpathy_train", n_train, 0),
                         ("coco_caption_karpathy_test", n_test, 50)):
        _write(os.path.join(d, f"{name}.arrow"), {
            "image": [_png(off + i, (36 + 8 * (i % 3), 60 - 6 * (i % 4))) for i in range(n)],
            "caption": [[CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(1 + i % 2)]
                        for i in range(n)],
            "image_id": [f"COCO_val2014_{off + i:012d}.jpg" for i in range(n)],
            "split": ["train"] * n})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("arrow")
    write_caption_tables(str(d))
    _write(str(d / "vqav2_val.arrow"), {
        "image": [_png(100 + i, (40, 48)) for i in range(3)],
        "questions": [["is the dog big", "what is running"] for _ in range(3)],
        "answers": [[["yes", "no"], ["dog"]] for _ in range(3)],
        "answer_labels": [[[0, 1], [2]] for _ in range(3)],
        "answer_scores": [[[1.0, 0.3], [0.6]] for _ in range(3)],
        "question_id": [[2 * i, 2 * i + 1] for i in range(3)],
        "split": ["val"] * 3})
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    return str(d), vocab


def _cfg_kw(d, vocab, keys):
    return dict(datasets=("coco",), data_root=d, tokenizer=vocab, hidden_size=32,
                num_heads=2, num_layers=2, patch_size=16, image_size=32,
                image_bucket_hw=(32, 48), max_text_len=12, train_transform_keys=keys,
                num_workers=2, seed=3)


def _assert_batches_equal(ours, ref, where):
    assert sorted(ours) == sorted(ref), (where, set(ours) ^ set(ref))
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert isinstance(ours[k], np.ndarray) and ours[k].dtype == v.dtype, (where, k)
            assert np.array_equal(ours[k], v), (where, k)
        else:
            assert ours[k] == v, (where, k)


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("keys", [("pixelbert",), ("pixelbert_randaug",)])
def test_loaders_yield_the_jax_batches(data, keys):
    """Two epochs of the train loader (drop_last; the second epoch resumed
    with skip_batches=1) and the val loader (wrap-padded, ``_valid``), the
    MLM masks included: every key of every batch equal."""
    d, vocab = data
    kw = _cfg_kw(d, vocab, keys)
    jdm = JDM.MultitaskDataModule(jax_build_config("task_moco", **kw))
    tdm = TDM.MultitaskDataModule(build_config("task_moco", **kw))
    jdm.setup()
    tdm.setup()
    n = 0
    for epoch, skip in ((0, 0), (1, 1)):
        jl, tl = jdm.train_loader(3), tdm.train_loader(3)
        assert len(jl) == len(tl) == 3
        jl.set_epoch(epoch, skip_batches=skip)
        tl.set_epoch(epoch, skip_batches=skip)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 3 - skip
        for i, (a, b) in enumerate(zip(tb, jb)):
            _assert_batches_equal(a, b, f"train epoch {epoch} batch {i}")
            assert a["image"].dtype == np.uint8 and a["image"].shape == (3, 6, 768)
            n += 1
    jb, tb = list(jdm.val_loader(4)), list(tdm.val_loader(4))
    assert len(jb) == len(tb) == 2
    for i, (a, b) in enumerate(zip(tb, jb)):
        _assert_batches_equal(a, b, f"val batch {i}")
    assert tb[-1]["_valid"].tolist() == [True, True, True, False]   # 7 captions
    assert n == 5 and any((b["text_labels_mlm"] != -100).any() for b in tb)


def test_randaugment_matches_the_jax_package():
    """RandAugment(2, 9) image for image, drawing from each package's
    per-sample stream of the same (seed, epoch, index); the 14 ops and their
    ranges are the original's."""
    assert [(op.__name__, lo, hi) for op, lo, hi in TT.RANDAUG_OPS] == \
        [(op.__name__, lo, hi) for op, lo, hi in JT.RANDAUG_OPS]
    r = np.random.RandomState(0)
    ours, ref = TT.RandAugment(2, 9), JT.RandAugment(2, 9)
    for i in range(40):
        img = Image.fromarray(r.randint(0, 256, (24 + i % 5, 30, 3), np.uint8))
        with TR.sample_rng(7, 1, i):
            a = np.asarray(ours(img))
        with JR.sample_rng(7, 1, i):
            b = np.asarray(ref(img))
        assert np.array_equal(a, b), i


@pytest.mark.parametrize("whole_word", [False, True], ids=["token", "whole_word"])
def test_rng_and_mlm_collator_match(data, whole_word):
    """The seeds of data/rng.py, and the MLM masks of one batch both inside a
    loader's batch scope and from the collator's own streams."""
    assert TR.sample_seed(3, 2, 11) == JR.sample_seed(3, 2, 11)
    assert TR.batch_seed(3, 2, 11, 1) == JR.batch_seed(3, 2, 11, 1)
    tok = get_tokenizer(data[1])
    enc = tok(CAPTIONS * 3, max_length=12, return_tensors="np")
    ours = TM.MLMCollator(tok, mlm_prob=0.3, whole_word=whole_word, seed=5)
    ref = JM.MLMCollator(tok, mlm_prob=0.3, whole_word=whole_word, seed=5)
    for scope in (None, TR.batch_seed(5, 0, 2, 0)):
        if scope is None:
            a = ours(enc["input_ids"], enc["special_tokens_mask"])
            b = ref(enc["input_ids"], enc["special_tokens_mask"])
        else:
            with TR.batch_rng(scope):
                a = ours(enc["input_ids"], enc["special_tokens_mask"])
            with JR.batch_rng(scope):
                b = ref(enc["input_ids"], enc["special_tokens_mask"])
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (a[1] != -100).any()


def test_vqa_dataset_and_collate_extras_match(data):
    """The VQA dataset's items and its soft-target collate extras."""
    d, vocab = data
    tok = get_tokenizer(vocab)
    kw = dict(data_dir=d, transform_keys=["pixelbert"], image_size=32, max_text_len=12,
              bucket_hw=(32, 48), image_dtype="uint8", split="val")
    ours = TD.VQAv2Dataset(tokenizer=tok, **kw)
    ref = JD.VQAv2Dataset(tokenizer=tok, **kw)
    assert len(ours) == len(ref) == 6
    items = [(ours[i], ref[i]) for i in range(len(ours))]
    for a, b in items:
        assert sorted(a) == sorted(b)
        assert np.array_equal(a["image"][0], b["image"][0])
        assert a["text"][0] == b["text"][0] and a["qid"] == b["qid"]
        assert (a["vqa_labels"], a["vqa_scores"]) == (b["vqa_labels"], b["vqa_scores"])
    t_out = TD.vqa_collate_extras([a for a, _ in items], {}, 5)
    j_out = JD.vqa_collate_extras([b for _, b in items], {}, 5)
    _assert_batches_equal(t_out, j_out, "vqa extras")


# -------------------------------------------------------------- metric bag
def _rets(r, B, valid):
    """Eval-step rets of moco (per-sample rows, a weighted one too), mlm,
    itm and vqa, with scalar telemetry."""
    ret = {"moco_loss": np.float32(r.rand()), "moco_loss_ps": r.rand(B).astype(np.float32),
           "attacked_txt_loss": np.float32(r.rand()),
           "attacked_txt_loss_ps": r.rand(B).astype(np.float32),
           "mlm_loss": np.float32(r.rand()), "mlm_loss_ps": r.rand(B).astype(np.float32),
           "mlm_loss_wt": r.randint(1, 4, B).astype(np.float32),
           "mlm_logits": r.randn(B, 5, 11).astype(np.float32),
           "mlm_labels": np.where(r.rand(B, 5) < 0.5, r.randint(0, 11, (B, 5)), -100),
           "itm_loss": np.float32(r.rand()), "itm_logits": r.randn(B, 2).astype(np.float32),
           "itm_labels": r.randint(0, 2, B), "vqa_loss": np.float32(r.rand()),
           "vqa_logits": r.randn(B, 7).astype(np.float32),
           "vqa_targets": r.rand(B, 7).astype(np.float32),
           "pgd_delta": np.float32(r.rand()), "total_loss": np.float32(r.rand())}
    return ret, valid


def test_metric_bag_matches_the_jax_package():
    """The same rets into both bags, wrap-padding rows masked by ``valid``:
    every metric of the epoch wrap-up equal, the ``_ps`` / ``_wt``
    recombination (PARITY #10) and ``the_metric`` included; then a second
    epoch after the reset."""
    names = loss_names({"moco": 1, "mlm": 1, "itm": 1, "vqa": 1})
    ours, ref = TMet.MetricBag(names), JMet.MetricBag(names)
    r = np.random.RandomState(0)
    for epoch in range(2):
        for valid in (None, np.ones(6, bool), np.array([1, 1, 1, 1, 0, 0], bool),
                      np.array([1, 0, 0, 0, 0, 0], bool)):
            ret, v = _rets(r, 6, valid)
            ours.update(ret, valid=v)
            ref.update(ret, valid=v)
        a, b = ours.epoch_wrapup("val"), ref.epoch_wrapup("val")
        assert a == b, epoch
        assert "val/the_metric" in a and "mlm_accuracy" in a and "pgd_delta" in a
    assert TMet.change_rate([1, 2, 3], [1, 0, 3]) == JMet.change_rate([1, 2, 3], [1, 0, 3])


# ------------------------------------------------------------ independence
def test_trainer_modules_import_without_pyarrow_pil_and_jax(tmp_path):
    """In a subprocess with pyarrow and PIL blocked: the Trainer and the data
    modules import, jax and rmcl_tpu stay out of sys.modules, and the loader
    collates an in-memory dataset of the arrow dataset's sample format into
    u8 patch rows (what chip_smoke.py's phase 15 relies on)."""
    code = f"""
import sys
sys.modules["pyarrow"] = None
sys.modules["PIL"] = None
sys.path.insert(0, {REPO!r})
import numpy as np
import rmcl_tpu_torch.train.loop, rmcl_tpu_torch.data.loader, rmcl_tpu_torch.data.mlm
import rmcl_tpu_torch.data.rng, rmcl_tpu_torch.data.datasets, rmcl_tpu_torch.eval.metrics
from rmcl_tpu_torch.core.config import build_config
from rmcl_tpu_torch.data.datamodule import MultitaskDataModule
from rmcl_tpu_torch.data.loader import ConcatDataset, DataLoader
from rmcl_tpu_torch.data.tokenizer import make_tiny_vocab
vocab = make_tiny_vocab({str(tmp_path / "vocab.txt")!r}, ["dog", "park"])
dm = MultitaskDataModule(build_config("task_moco", tokenizer=vocab, max_text_len=8,
                                      patch_size=16, image_bucket_hw=(32, 48)))
enc = dm.tokenizer("a dog", max_length=8)
samples = [{{"image": [np.full((32, 16 * (1 + i % 3), 3), i, np.uint8)], "text": ("a dog", enc),
            "img_index": i, "cap_index": 0, "raw_index": i, "replica": False}}
           for i in range(5)]
batches = list(DataLoader(ConcatDataset([samples]), 2, dm.collate, drop_last=False,
                          num_workers=2))
assert [b["image"].shape for b in batches] == [(2, 6, 768)] * 3, batches
assert batches[-1]["_valid"].tolist() == [True, False]
assert batches[0]["image_hw"].dtype == np.int32
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rmcl_tpu"))
assert not bad, bad
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().endswith("OK")
