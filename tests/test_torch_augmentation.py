"""The port's benign views (data/augmentation.py: EDA, TextAugmentation,
SimCLRTransform, ImageAugmentation) and the steps, the Trainer and the CLI
with ``augmentation=True``, against the JAX package on the CPU in fp32.

Both packages draw from ``data/rng.py:srandom``, which outside a loader
falls back to Python's global ``random``: each comparison seeds it before
the JAX call and again before the port's, so that the same draws are taken
in the same order; equal outputs and an equal next draw show that.  Texts,
token ids and SimCLR pixels are held equal.  Both sides build
TextAugmentation with ``sentence_transformers`` and ``transformers`` blocked
in ``sys.modules`` (the ``offline`` fixture): that is what a machine with
neither model cached resolves to, EDA candidates ranked by Jaccard, without
the JAX package's wait on the hub for SBERT.

The Trainer: tests/test_eval.py's benign-view configuration, fit and
validate against the JAX Trainer's losses.  The benign-view steps are in
tests/test_torch_benign_steps.py (apart so that the two files run on
separate workers)."""

import os
import random
import sys

import jax
import numpy as np
import pytest

from rmcl_tpu.core.config import build_config
from rmcl_tpu.data import augmentation as JA
from rmcl_tpu.data import datasets as JD
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.train import loop as JL
from rmcl_tpu_torch.data import augmentation as TA
from rmcl_tpu_torch.data import datasets as TDS
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.train import loop as TL
from tests.test_attacks import WORDS
from tests.test_torch_train import _port_of
from tests.test_torch_trainer import CAPTIONS, write_tables
from tests._torch_threads import one_thread  # noqa: F401

TEXTS = ["A dog, running in the park!", "the red cat sits on a mat",
         "big-dog's toy\tball near the old tree", "one"]
SYNONYMS = {"dog": ["hound", "puppy", "cur"], "park": ["garden", "green"],
            "cat": ["kitten"], "red": ["crimson", "scarlet"], "running": ["jogging"],
            "sits": ["rests", "perches"], "tree": ["oak"], "ball": ["sphere", "orb"]}


def syn(word):
    return list(SYNONYMS.get(word, []))


class _Table:
    """What EDA's table source reads of a SynonymTable."""

    def candidates(self, word):
        return [word] + syn(word)


def _twice(seed, jax_fn, port_fn):
    """(JAX result, port result), each from ``random.seed(seed)``, and the
    next draw after each (equal iff both took as many draws)."""
    random.seed(seed)
    want = jax_fn()
    after_j = random.random()
    random.seed(seed)
    got = port_fn()
    return want, got, after_j, random.random()


@pytest.fixture
def offline(monkeypatch):
    for name in ("sentence_transformers", "transformers"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("augmentation")
    words = sorted(set(WORDS) | {w for k, v in SYNONYMS.items() for w in [k, *v]})
    return make_tiny_vocab(str(d / "vocab.txt"), words)


# ------------------------------------------------------------------- EDA
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_eda_operations_match_jax(seed):
    """get_only_chars, the four operations and eda (num_aug 1, 5, 9,
    original on and off), _jaccard and the synonym sources: equal outputs,
    the same number of draws."""
    for text in TEXTS:
        assert TA.get_only_chars(text) == JA.get_only_chars(text)
        words = [w for w in TA.get_only_chars(text).split(" ") if w] or [""]
        for name, args in (("synonym_replacement", (words, 2, syn)),
                           ("random_insertion", (words, 2, syn)),
                           ("random_swap", (words, 3)), ("random_deletion", (words, 0.3))):
            want, got, a, b = _twice(seed, lambda: getattr(JA, name)(*args),
                                     lambda: getattr(TA, name)(*args))
            assert got == want and a == b, (name, text)
        for num_aug, original in ((1, False), (5, True), (9, False)):
            want, got, a, b = _twice(
                seed, lambda: JA.eda(text, num_aug=num_aug, original=original, syn=syn),
                lambda: TA.eda(text, num_aug=num_aug, original=original, syn=syn))
            assert got == want and a == b, (text, num_aug)
        assert TA._jaccard(text.lower(), "a dog in the park") == JA._jaccard(
            text.lower(), "a dog in the park")
    assert TA._TableSource(_Table())("dog") == JA._TableSource(_Table())("dog") == syn("dog")
    # WordNet's data is not installed here: both fall back to the table, then identity
    assert TA.default_synonym_source(_Table())("cat") == JA.default_synonym_source(
        _Table())("cat")
    assert TA.default_synonym_source()("dog") == JA.default_synonym_source()("dog")


def test_text_augmentation_matches_jax(vocab, offline):
    """TextAugmentation.augment (PEGASUS and EDA asked for, neither model
    loadable: EDA's 5 candidates ranked by Jaccard) at epochs 0, 1 and 7:
    texts, ids and masks equal, the same number of draws."""
    cfg = build_config(max_text_len=12, num_return_sequences=5)
    assert "PEGASUS" in cfg.type_txt_augm
    jt = JA.TextAugmentation(cfg, JTokenizer(vocab), synonym_table=_Table())
    tt = TA.TextAugmentation(cfg, WordPieceTokenizer(vocab), synonym_table=_Table())
    assert jt.pegasus is jt.ranker is tt.pegasus is tt.ranker is None
    for seed, epoch in ((0, 0), (1, 1), (2, 7)):
        want, got, a, b = _twice(seed, lambda: jt.augment(TEXTS, epoch=epoch),
                                 lambda: tt.augment(TEXTS, epoch=epoch))
        assert got[0] == want[0] and a == b, epoch
        for x, y in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(x, y)
    assert got[0] != [TA.get_only_chars(t) for t in TEXTS]   # the views differ


# ----------------------------------------------------------------- SimCLR
@pytest.fixture(scope="module")
def tables(tmp_path_factory, vocab):
    d = tmp_path_factory.mktemp("simclr_tables")
    write_tables(str(d), CAPTIONS, n_train=6, n_test=4)
    kw = dict(data_dir=str(d), transform_keys=["pixelbert"], image_size=32,
              max_text_len=12, bucket_hw=(32, 48), split="train")
    return (JD.CocoCaptionKarpathyDataset(tokenizer=JTokenizer(vocab), **kw),
            TDS.CocoCaptionKarpathyDataset(tokenizer=WordPieceTokenizer(vocab), **kw))


def test_simclr_views_match_jax_bit_for_bit(tables):
    """SimCLRTransform (size 32 and 64) on the table's images over seeds that
    reach every branch (mirror, colour jitter, greyscale, solarize), and
    ImageAugmentation.augment_indices into the (32, 48) canvas: the arrays
    equal bit for bit, the same number of draws."""
    jds, tds = tables
    img = tds.get_raw_image(0)
    for size in (32, 64):
        jt, tt = JA.SimCLRTransform(size), TA.SimCLRTransform(size)
        for seed in range(12):
            want, got, a, b = _twice(seed, lambda: jt(img), lambda: tt(img))
            assert got.dtype == want.dtype == np.float32 and a == b
            np.testing.assert_array_equal(got, want, err_msg=f"size {size} seed {seed}")
    rows = [0, 3, 1, 5, 3]
    want, got, a, b = _twice(
        7, lambda: JA.ImageAugmentation(jds, size=32).augment_indices(rows, (32, 48)),
        lambda: TA.ImageAugmentation(tds, size=32).augment_indices(rows, (32, 48)))
    assert got.shape == (5, 32, 48, 3) and a == b
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- the Trainer
def _benign_cfg(arrow, out, **kw):
    """tests/test_eval.py's test_trainer_benign_augmentation_moco config."""
    return dict(
        datasets=("coco",), data_root=str(arrow), hidden_size=32, num_heads=2,
        num_layers=1, patch_size=16, image_size=32, image_bucket_hw=(32, 48),
        max_text_len=12, vocab_size=64, num_negative=8, use_pallas_attention=False,
        compute_dtype="float32", drop_rate=0.0, max_steps=2, warmup_steps=0,
        batch_size=4, num_workers=2, fast_dev_run=True, max_image_len=-1,
        augmentation=True, text_view=True, image_view=True, type_txt_augm=("EDA",),
        log_dir=str(out), log_every_n_steps=1, **kw)


def test_benign_trainer_matches_the_jax_trainer(tmp_path, offline):
    """tests/test_eval.py's benign-view task_moco run (fast_dev_run: one step
    and its validation, the next batch's views prefetched and drained) on
    the same weights, data and global ``random`` seed as the JAX Trainer:
    its step's losses (rtol 1e-4) and its validation's (rtol 2e-3, after one
    AdamW step), the views' losses among them; validate() again equal."""
    from rmcl_tpu_torch.core.config import build_config as port_build_config
    from tests.test_eval import _write_caption_arrow
    from tests.test_torch_trainer import _records, _steps
    arrow = tmp_path / "arrow"
    arrow.mkdir()
    _write_caption_arrow(str(arrow))
    vocab = make_tiny_vocab(str(tmp_path / "vocab.txt"),
                            ["dog", "running", "park", "the", "in", "a"])
    jcfg = build_config("task_moco", **_benign_cfg(arrow, tmp_path / "jax"))
    jtr = JL.Trainer(jcfg, workdir=jcfg.log_dir, vocab_path=vocab, use_mesh=False)
    jtr.setup()
    params, state = jax.tree.map(np.array, (jtr.ts.params, jtr.ts.state))
    cfg = port_build_config("task_moco", tokenizer=vocab,
                            **_benign_cfg(arrow, tmp_path / "port"))
    tr = TL.Trainer(cfg, workdir=cfg.log_dir, device="cpu")
    tr.setup(model=_port_of(cfg, params, state))
    assert tr.greedy is None and tr.text_augment is not None and tr.image_augment is not None
    assert not tr._text_bucket
    random.seed(0)
    jtr.fit()
    jvm = jtr.validate()
    random.seed(0)
    tr.fit()
    vm = tr.validate()
    ours, ref = _records(tr.workdir), _records(jtr.workdir)
    (step,), (jstep,) = _steps(ours), _steps(ref)
    for key in ("train/total_loss", "train/moco_loss", "train/attacked_txt_loss",
                "train/attacked_img_loss"):
        np.testing.assert_allclose(step[key], jstep[key], rtol=1e-4, atol=1e-5, err_msg=key)
    val = [r for r in ours if "val_epoch/moco_loss" in r]
    jval = [r for r in ref if "val_epoch/moco_loss" in r]
    assert len(val) == len(jval) == 1
    for a, b in ((val[0], jval[0]), (vm, jvm)):
        keys = {k for k in b if "loss" in k}
        assert keys and keys == {k for k in a if "loss" in k}
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, atol=1e-5, err_msg=k)
    assert np.isfinite(vm["moco_loss"]) and "attacked_txt_loss" in vm
    assert "attacked_img_loss" in vm and "attacked_both_loss" not in vm


def test_cli_trains_with_benign_views_on_the_cpu(tmp_path, offline, capsys):
    """``cli.run with task_moco augmentation=True ... device=cpu``: one step
    on the EDA and SimCLR views, its validation and the checkpoints."""
    from rmcl_tpu_torch.cli.run import main
    d = tmp_path / "data"
    d.mkdir()
    write_tables(str(d), CAPTIONS, n_train=4, n_test=2)
    vocab = make_tiny_vocab(str(tmp_path / "vocab.txt"), WORDS)
    V = WordPieceTokenizer(vocab).vocab_size
    args = ["with", "task_moco", "fast_dev_run=True", f"data_root={d}",
            f"tokenizer={vocab}", "hidden_size=32", "num_heads=2", "num_layers=1",
            "patch_size=16", "image_size=32", "image_bucket_hw=(32,48)", "max_text_len=12",
            f"vocab_size={V}", "num_negative=16", "max_image_len=4", "compute_dtype=float32",
            "drop_rate=0.0", "augmentation=True", "text_view=True", "image_view=True",
            "batch_size=2", "num_workers=0", f"log_dir={tmp_path / 'log'}", "device=cpu"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "val/the_metric" in out and "attacked_img_loss" in out
    assert os.path.isfile(tmp_path / "log" / "moco" / "LAST.ptr")
