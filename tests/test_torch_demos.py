"""The port's demos (``rmcl_tpu_torch/demos``) and t-SNE projection
(``rmcl_tpu_torch/eval/tsne.py``) against the JAX package's, on the CPU in
fp32 at the tiny size of ``tests/test_augmentation_demos.py``'s fixture: the
same weights (the JAX package's init carried across), tokenizer vocabulary
and PIL image.

Tolerances.  ``prepare_image`` and ``mlm_fill``'s steps: equal.  ``answer``:
the same names in the same order, probabilities within 1e-6 (fp32 rounding of
a softmax of logits that agree to ~1e-6).  The heatmap: 1e-4 absolute
(HEAT_TOL).  Its plan agrees to a few fp32 ulps, but the normalisation divides
twice, by the grid's standard deviation and by the range of the values
clipped to [1, 3]; a cell near a clip point moves the range by its own
error, so the ulps are magnified by up to 1 / range (the largest error
measured over these cases: 5.4e-7).  The demo CLIs print the same lines as
the JAX package's on the same checkpoint file.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.data.tokenizer import WordPieceTokenizer, make_tiny_vocab
from rmcl_tpu.demos import demo as jax_demo
from rmcl_tpu.demos import demo_vqa as jax_demo_vqa
from rmcl_tpu.demos.inference import DemoEngine as JaxEngine
from rmcl_tpu.demos.inference import prepare_image as jax_prepare_image
from rmcl_tpu.eval.tsne import tsne_projection as jax_tsne
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu_torch.compat.from_jax import state_dict_from_jax
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer as PortTokenizer
from rmcl_tpu_torch.demos import demo as port_demo
from rmcl_tpu_torch.demos import demo_vqa as port_demo_vqa
from rmcl_tpu_torch.demos.inference import DemoEngine, prepare_image
from rmcl_tpu_torch.eval.tsne import tsne_projection
from rmcl_tpu_torch.models.vilt import ViLT
from tests._torch_threads import one_thread  # noqa: F401

HEAT_TOL = 1e-4
PROB_TOL = 1e-6
WORDS = ["dog", "cat", "animal", "grass", "photo", "sitting", "on", "the", "a", "what", "is"]
TINY = dict(hidden_size=32, num_heads=2, num_layers=2, patch_size=16, image_size=32,
            image_bucket_hw=(32, 48), max_text_len=12, vqav2_label_size=7,
            max_image_len=-1, compute_dtype="float32", drop_rate=0.0)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("v") / "vocab.txt")
    make_tiny_vocab(p, WORDS)
    return p


@pytest.fixture(scope="module")
def engines(vocab):
    """The JAX fixture of tests/test_augmentation_demos.py:72-89 and the
    port's engine on its weights."""
    tok = WordPieceTokenizer(vocab)
    cfg = build_config(**TINY, vocab_size=tok.vocab_size, use_pallas_attention=False,
                       loss_names=loss_names({"mlm": 1, "itm": 1, "vqa": 1}))
    params, _ = init_vilt(jax.random.PRNGKey(0), cfg)
    id2answer = {i: f"ans{i}" for i in range(7)}
    model = ViLT(cfg)
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers).items()}) == []
    return (JaxEngine(cfg, params, tok, id2answer=id2answer),
            DemoEngine(cfg, model, PortTokenizer(vocab), id2answer=id2answer, device="cpu"))


@pytest.fixture(scope="module")
def pil_img():
    return Image.fromarray(np.random.RandomState(1).randint(0, 255, (40, 56, 3), np.uint8))


def test_prepare_image_matches_jax(engines, pil_img):
    jax_eng, eng = engines
    ours = prepare_image(pil_img, eng.cfg)
    assert ours.shape == (1, 32, 48, 3)
    np.testing.assert_array_equal(ours, jax_prepare_image(pil_img, jax_eng.cfg))


@pytest.mark.parametrize("text", ["a [MASK] sitting on the [MASK]",
                                  "what is [MASK] [MASK] [MASK]", "a photo of the grass"])
def test_mlm_fill_matches_jax(engines, pil_img, text):
    jax_eng, eng = engines
    filled, steps = eng.mlm_fill(pil_img, text)
    assert (filled, steps) == jax_eng.mlm_fill(pil_img, text)
    assert len(steps) == text.count("[MASK]") + 1 and "[MASK]" not in filled


@pytest.mark.parametrize("token_idx,iters", [(2, 10), (4, 100)])
def test_wpa_heatmap_matches_jax(engines, pil_img, token_idx, iters):
    jax_eng, eng = engines
    text = "a dog sitting on the grass"
    heat, token = eng.wpa_heatmap(pil_img, text, token_idx=token_idx, ot_iterations=iters)
    ref, ref_token = jax_eng.wpa_heatmap(pil_img, text, token_idx=token_idx,
                                         ot_iterations=iters)
    assert heat.shape == ref.shape == (32 // 16, 48 // 16) and token == ref_token
    assert np.all(heat >= 0) and np.all(heat <= 1)
    assert np.abs(heat - ref).max() <= HEAT_TOL, np.abs(heat - ref).max()


def test_answer_matches_jax(engines, pil_img):
    jax_eng, eng = engines
    for topk in (3, 7):
        ours = eng.answer(pil_img, "what animal is this", topk=topk)
        ref = jax_eng.answer(pil_img, "what animal is this", topk=topk)
        assert [a for a, _ in ours] == [a for a, _ in ref]
        np.testing.assert_allclose([p for _, p in ours], [p for _, p in ref], rtol=0,
                                   atol=PROB_TOL)


def test_engine_takes_a_prepared_canvas_and_needs_a_card_unless_asked(engines, pil_img):
    _, eng = engines
    canvas = prepare_image(pil_img, eng.cfg)
    assert eng.answer(canvas, "what is this") == eng.answer(pil_img, "what is this")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DemoEngine(eng.cfg, eng.model, eng.tokenizer)


# ------------------------------------------------------------------ the CLIs
def _tiny_config(real, vocab_size, jax_side):
    extra = {"use_pallas_attention": False} if jax_side else {}

    def build(*names, **kw):
        return real(*names, **{**kw, **TINY, "vocab_size": vocab_size, **extra})
    return build


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, vocab):
    """A reference-named .ckpt with every head the two demos read."""
    vocab_size = WordPieceTokenizer(vocab).vocab_size
    cfg = build_config(**TINY, vocab_size=vocab_size, use_pallas_attention=False,
                       loss_names=loss_names({"mlm": 1, "itm": 1, "vqa": 1}))
    params, _ = init_vilt(jax.random.PRNGKey(7), cfg)
    path = str(tmp_path_factory.mktemp("ck") / "tiny.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               state_dict_from_jax(params, cfg.num_layers).items()}}, path)
    return path


def _run(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["demo"] + argv)
    main()
    return capsys.readouterr().out.splitlines()


def test_demo_cli_prints_the_jax_lines(ckpt, vocab, pil_img, tmp_path, monkeypatch, capsys):
    vocab_size = WordPieceTokenizer(vocab).vocab_size
    monkeypatch.setattr(jax_demo, "build_config",
                        _tiny_config(jax_demo.build_config, vocab_size, True))
    monkeypatch.setattr(port_demo, "build_config",
                        _tiny_config(port_demo.build_config, vocab_size, False))
    image = str(tmp_path / "img.png")
    pil_img.save(image)
    argv = ["--ckpt", ckpt, "--vocab", vocab, "--image", image,
            "--text", "a [MASK] sitting on the [MASK]", "--hidx", "2"]
    ref = _run(jax_demo.main, argv, monkeypatch, capsys)
    ours = _run(port_demo.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    assert ours == ref and len(ref) == 1 + 3 + 1 + 2, ref
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run(port_demo.main, argv, monkeypatch, capsys)


def test_demo_vqa_cli_prints_the_jax_lines(ckpt, vocab, pil_img, tmp_path, monkeypatch,
                                           capsys):
    vocab_size = WordPieceTokenizer(vocab).vocab_size
    for mod, jax_side in ((jax_demo_vqa, True), (port_demo_vqa, False)):
        monkeypatch.setattr(mod, "build_config",
                            _tiny_config(mod.build_config, vocab_size, jax_side))
    image, answers = str(tmp_path / "img.png"), str(tmp_path / "answers.json")
    pil_img.save(image)
    with open(answers, "w") as fp:
        json.dump({str(i): f"answer {i}" for i in range(7)}, fp)
    argv = ["--ckpt", ckpt, "--vocab", vocab, "--answers", answers, "--image", image,
            "--question", "what animal is this"]
    ref = _run(jax_demo_vqa.main, argv, monkeypatch, capsys)
    ours = _run(port_demo_vqa.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    assert ours == ref and len(ref) == 5, ref


def test_demo_configs_are_the_jax_demos():
    """The unpatched configs: the demo at S = 19 x 19 + 1 + 40 = 402 (the
    608 x 608 canvas, every patch), the VQA demo's 3,129 answers."""
    cfg, jcfg = port_demo.config(), jax_demo.build_config(
        loss_names=loss_names({"mlm": 1, "itm": 1}), image_bucket_hw=(608, 608))
    gh, gw = cfg.grid_hw
    assert (gh * gw + 1 + cfg.max_text_len, cfg.max_image_len) == (402, -1)
    assert (cfg.loss_names, cfg.grid_hw) == (jcfg.loss_names, jcfg.grid_hw)
    vqa = port_demo_vqa.config()
    assert vqa.vqav2_label_size == 3129 and vqa.loss_names == jax_demo_vqa.build_config(
        "task_finetune_vqa", test_only=True).loss_names


# ------------------------------------------------------------------- t-SNE
def _tsne_inputs():
    r = np.random.RandomState(0)
    q = r.randn(8, 16)
    return q, q + 0.01 * r.randn(8, 16), r.randn(16, 64)


def test_tsne_embeddings_equal_jax(tmp_path, monkeypatch):
    """matplotlib blocked on both sides: each saves its 2-D embedding as
    .npy; the port is given tensors, the JAX package arrays."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    q, k, queue = _tsne_inputs()
    ref = jax_tsne(q, k, queue, out_path=str(tmp_path / "j.png"), max_negatives=32,
                   perplexity=5)
    ours = tsne_projection(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(queue),
                           out_path=str(tmp_path / "t.png"), max_negatives=32, perplexity=5)
    assert ours == str(tmp_path / "t.png.npy") and ref == str(tmp_path / "j.png.npy")
    a, b = np.load(ours), np.load(ref)
    assert a.shape == (8 + 8 + 32, 2)
    np.testing.assert_array_equal(a, b)


def test_tsne_writes_the_png(tmp_path):
    q, k, queue = _tsne_inputs()
    out = tsne_projection(q, k, queue, out_path=str(tmp_path / "t.png"),
                          max_negatives=32, perplexity=5)
    assert out == str(tmp_path / "t.png")
    with open(out, "rb") as fp:
        assert fp.read(8) == b"\x89PNG\r\n\x1a\n"
