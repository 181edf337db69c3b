"""The port's AOT serving artifact (rmcl_tpu_torch/serve.py: export_inference,
load_artifact, ArtifactSession; cli/run.py: export, serve ARTIFACT) on the
CPU in fp32, against the JAX package's (rmcl_tpu/serve.py, its StableHLO
artifact) and against the port's live inference:

  * per task, the port's artifact exported, saved and loaded, with the JAX
    parameters carried across (compat/from_jax.py), against the JAX
    artifact's output within 1e-5 x max(1, max|ref|) (fp32 sums in another
    order), and against the port's live ``build_infer_fn`` bit for bit (the
    same ops on the same inputs); the program holds L rmcl.attn_half and L
    rmcl.mlp_half nodes (configuration P, on the embed task: L
    rmcl.masked_attention) and no parameter or constant; a second seed's parameters give that model's live
    output bit for bit;
  * ``torch.library.opcheck`` on the three operators;
  * the u8 wire against the f32 artifact within 1e-5 x max(1, max|ref|);
  * ArtifactSession: chunks and pad-by-repeat (bit for bit), the hwc canvas
    against patch rows (1e-5 x max(1, max|ref|): the same pixels), overlong
    text truncated to the artifact's length (bit for bit);
  * the CLI: ``export`` then ``serve ARTIFACT`` against the JAX CLI's
    records on the same PNG requests and weights (the answer ids equal, the
    probabilities within 1e-5); without ``device=cpu`` on a box with no card
    ``export``, ``serve`` and ``load_artifact`` raise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.serve import export_inference as jax_export
from rmcl_tpu.serve import load_artifact as jax_load
from rmcl_tpu_torch.compat.from_jax import state_dict_from_jax
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.ops import attention as A
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.serve import (TASKS, ArtifactSession, build_infer_fn, export_inference,
                                  export_meta, load_artifact, seeded_model)
from tests._torch_threads import one_thread  # noqa: F401
from tests.test_torch_serve import TASK_LOSS, TINY, _pair, _wire

RTOL = 1e-5
NODES = {"default": ("rmcl.attn_half.default", "rmcl.mlp_half.default"),
         "P": ("rmcl.masked_attention.default", "rmcl.mlp_half.default")}


def _cfg(task, **kw):
    return build_config(**{**TINY, "num_layers": 1, "loss_names": loss_names(TASK_LOSS[task]),
                           **kw})


def _close(name, ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rtol * max(1.0, np.abs(ref).max()), (name, err)


def _live(cfg, model, task, batch):
    with torch.no_grad():
        return build_infer_fn(cfg, task)(model, {k: torch.from_numpy(v) for k, v in batch.items()})


def _nodes(art) -> dict:
    out = {}
    for n in art.program.graph.nodes:
        if str(n.target).startswith("rmcl."):
            out[str(n.target)] = out.get(str(n.target), 0) + 1
    return out


@pytest.fixture(scope="module")
def jax_side():
    """task -> (cfg, JAX params, the port's model on them, a u8 wire batch,
    the JAX artifact's output on it), made once per task."""
    cache = {}

    def get(task):
        if task not in cache:
            cfg = _cfg(task)
            params, model = _pair(cfg)
            b = _wire(cfg, 2)
            ref = jax_load(jax_export(cfg, params, task, 2))(
                params, {k: jnp.asarray(v) for k, v in b.items()})
            cache[task] = (cfg, model, b, np.asarray(ref))
        return cache[task]
    return get


@pytest.mark.parametrize("task,impl", [(t, "default") for t in TASKS] + [("embed", "P")])
def test_artifact_matches_jax_and_live(task, impl, jax_side, tmp_path):
    """Export -> file -> load on the CPU: the JAX artifact's output on the
    JAX parameters, the live port bit for bit, the operator nodes, no
    parameter inside; under P against the JAX artifact of the default
    blocks (the same function)."""
    cfg, model, b, ref = jax_side(task)
    if impl == "P":
        pcfg = _cfg(task, attention_impl="pallas")
        pmodel = ViLT(pcfg)
        pmodel.load_state_dict(model.state_dict())
        cfg_port, model = pcfg, pmodel
    else:
        cfg_port = cfg
    path = str(tmp_path / f"{task}.pt2")
    blob = export_inference(cfg_port, model, task, 2, out_path=path, device="cpu")
    with open(path, "rb") as f:
        assert f.read() == blob
    with open(path + ".json") as f:
        assert json.load(f) == export_meta(cfg_port, task, 2)
    art = load_artifact(path, "cpu")
    assert len(art.program.state_dict) == 0 and len(art.program.constants) == 0
    assert _nodes(art) == {n: cfg.num_layers for n in NODES[impl]}
    ours = art(model.state_dict(), b)
    assert torch.equal(ours, _live(cfg_port, model, task, b))
    _close(f"{task} {impl}", ours.numpy(), ref)
    if task == "vqa" and impl == "default":      # another checkpoint of the architecture
        other = seeded_model(cfg_port, 1)
        assert torch.equal(art(other.state_dict(), b), _live(cfg_port, other, task, b))
        assert not torch.equal(art(other.state_dict(), b), ours)


def test_opcheck_the_operators():
    """The three operators' schema, fake kernels and autograd registration
    (torch.library.opcheck), fp32 and bf16, a shard's missing bias too."""
    r = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))  # noqa: E731
    B, S, C, H = 2, 5, 16, 2
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, 3:] = 0
    for dt in (torch.float32, torch.bfloat16):
        x = t(B, S, C).to(dt)
        attn = (x, mask, 1 + t(C), t(C), t(3 * C, C).to(dt), t(3 * C), t(C, C).to(dt))
        mlp = (x, 1 + t(C), t(C), t(4 * C, C).to(dt), t(4 * C), t(C, 4 * C).to(dt))
        for bias, residual, keep in ((t(C), True, True), (None, False, False)):
            torch.library.opcheck(FB._attn_half_op, (*attn, bias, H, 1e-6, residual))
            torch.library.opcheck(FB._mlp_half_op, (*mlp, bias, 1e-6, residual, keep))
        q, k, v = (t(B, H, S, C // H).to(dt) for _ in range(3))
        torch.library.opcheck(A._masked_attention_op, (q, k, v, mask, 0.5))


def test_u8_wire_matches_f32_artifact():
    """A u8-wire artifact normalises in the graph: the f32-wire artifact fed
    the same pixels normalised on the host gives the same output."""
    cfg8, cfg32 = _cfg("embed"), _cfg("embed", image_dtype="float32")
    _, model = _pair(cfg8)
    b8 = _wire(cfg8, 2)
    u8 = b8["image"].astype(np.float32)
    norm = (u8 / 255.0 - 0.5) / 0.5
    gh, gw = cfg8.grid_hw
    P = cfg8.patch_size
    n, e = np.arange(norm.shape[1]), np.arange(norm.shape[2])
    py = (n // gw)[:, None] * P + e[None, :] // (P * 3)
    px = (n % gw)[:, None] * P + (e[None, :] % (P * 3)) // 3
    hw = b8["image_hw"]
    valid = (py[None] < hw[:, 0, None, None]) & (px[None] < hw[:, 1, None, None])
    b32 = {k: v for k, v in b8.items() if k != "image_hw"}
    b32["image"] = np.where(valid, norm, 0.0).astype(np.float32)
    sd = model.state_dict()
    out8 = load_artifact(export_inference(cfg8, model, "embed", 2, device="cpu"), "cpu")(sd, b8)
    out32 = load_artifact(export_inference(cfg32, model, "embed", 2, device="cpu"),
                          "cpu")(sd, b32)
    _close("u8 vs f32", out8.numpy(), out32.numpy())


# ------------------------------------------------------------ the session
def _vocab(tmp_path):
    from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer, make_tiny_vocab
    p = make_tiny_vocab(str(tmp_path / "vocab.txt"), ["dog", "cat", "park", "the", "red"])
    return p, WordPieceTokenizer(p)


def _images(n, seed=0):
    r = np.random.RandomState(seed)
    sizes = [(40, 56), (64, 32), (48, 48), (80, 40)]
    return [r.randint(0, 256, (*sizes[i % 4], 3)).astype(np.uint8) for i in range(n)]


def test_artifact_session(tmp_path):
    """ArtifactSession.open over the host pipeline: 3 requests through a
    batch-2 artifact (a padded chunk) equal each served alone; the hwc canvas
    serves the patch rows' results; an overlong text serves as its
    truncation."""
    vocab, tok = _vocab(tmp_path)
    imgs, texts = _images(3), ["the dog", "a cat in the park", "dog park"]
    outs = {}
    for layout in ("patch", "hwc"):
        cfg = _cfg("embed", image_layout=layout, tokenizer=vocab)
        model = seeded_model(cfg, 0)
        path = str(tmp_path / f"{layout}.pt2")
        export_inference(cfg, model, "embed", 2, out_path=path, device="cpu")
        sess = ArtifactSession.open(path, model.state_dict(), device="cpu")
        assert sess.meta == export_meta(cfg, "embed", 2) and sess.batch_size == 2
        outs[layout] = out = sess.predict(imgs, texts)
        assert out.shape == (3, 128) and np.isfinite(out).all()
        alone = np.concatenate([sess.predict(imgs[i:i + 1], texts[i:i + 1]) for i in range(3)])
        np.testing.assert_array_equal(out, alone)
    _close("hwc vs patch", outs["hwc"], outs["patch"])
    long = " ".join(["red dog"] * 20)
    ids = tok([long], max_length=cfg.max_text_len)["input_ids"][0]
    cut = " ".join(tok.convert_ids_to_tokens(int(i)) for i in ids[1:-1])
    np.testing.assert_array_equal(sess.predict(imgs[:1], [long]), sess.predict(imgs[:1], [cut]))


# ------------------------------------------------------------------ CLI
def test_cli_export_and_serve_match_jax_cli(tmp_path, capsys):
    """``export vqa OUT batch_size=2 device=cpu`` then ``serve OUT`` on three
    PNG requests, on the JAX parameters of the config's seed carried as a
    torch file, against the JAX CLI's ``export`` / ``serve`` on the same
    requests; and the refusals without a card."""
    from PIL import Image

    from rmcl_tpu.cli.run import main as jax_main
    from rmcl_tpu_torch.cli.run import main
    vocab, _ = _vocab(tmp_path)
    overrides = [f"{k}={v!r}" for k, v in TINY.items() if k != "image_dtype"] + [
        "num_layers=1", "loss_names={'vqa': 1}", f"tokenizer={vocab}", "seed=0"]
    cfg = build_config(**{**TINY, "num_layers": 1, "loss_names": loss_names({"vqa": 1}),
                          "tokenizer": vocab, "seed": 0, "image_dtype": "uint8"})
    params, _ = init_vilt(jax.random.PRNGKey(0), cfg)
    ckpt = str(tmp_path / "vqa.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               state_dict_from_jax(params, cfg.num_layers).items()}}, ckpt)
    inp = str(tmp_path / "reqs.jsonl")
    with open(inp, "w") as f:
        for i, im in enumerate(_images(3, seed=7)):
            Image.fromarray(im).save(str(tmp_path / f"im{i}.png"))
            f.write(json.dumps({"image": str(tmp_path / f"im{i}.png"),
                                "text": f"the red dog {i}"}) + "\n")
    jart, art = str(tmp_path / "vqa.stablehlo"), str(tmp_path / "vqa.pt2")
    assert jax_main(["export", "vqa", jart, "batch_size=2", "with", *overrides]) == 0
    assert jax_main(["serve", jart, f"input={inp}", f"output={tmp_path / 'jax.jsonl'}",
                     "with", *overrides]) == 0
    assert main(["export", "vqa", art, "batch_size=2", "device=cpu", "with", *overrides,
                 f"load_path={ckpt}"]) == 0
    assert main(["serve", art, f"input={inp}", f"output={tmp_path / 'ours.jsonl'}",
                 "device=cpu", "with", *overrides, f"load_path={ckpt}"]) == 0
    assert "exported vqa (batch 2" in capsys.readouterr().out
    recs = [[json.loads(ln) for ln in open(tmp_path / f"{n}.jsonl")] for n in ("ours", "jax")]
    assert len(recs[0]) == len(recs[1]) == 3
    for a, b in zip(*recs):
        assert [j for j, _ in a["answers"]] == [j for j, _ in b["answers"]]
        np.testing.assert_allclose([p for _, p in a["answers"]], [p for _, p in b["answers"]],
                                   atol=1e-5)
    if not torch.cuda.is_available():
        for argv in (["export", "vqa", str(tmp_path / "x.pt2"), "with", *overrides],
                     ["serve", art, f"input={inp}", "with", *overrides]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_artifact(art)
