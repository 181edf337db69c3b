"""The port's serving path (rmcl_tpu_torch/serve.py, cli/run.py) against
the JAX package's, on CPU in fp32; the port's independence from jax (the
live session, the CLI and the AOT artifact); and chip_smoke.py's refusal to
run without a card."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _fake_batch
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.serve import build_infer_fn as jax_infer_fn
from rmcl_tpu_torch.compat.from_jax import state_dict_from_jax
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.serve import TASKS, Session, batch_spec, build_infer_fn
from tests._torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-4
TASK_LOSS = {"mlm": {"mlm": 1}, "itm": {"itm": 1}, "rank": {"irtr": 1},
             "vqa": {"vqa": 1}, "embed": {"moco": 1}}
TINY = dict(hidden_size=32, num_heads=2, num_layers=2, patch_size=16,
            image_size=32, image_bucket_hw=(32, 48), max_text_len=10,
            vocab_size=64, use_pallas_attention=False,
            compute_dtype="float32", drop_rate=0.0, vqav2_label_size=7,
            image_dtype="uint8")


def _cfg(task, **kw):
    return build_config(**{**TINY, "loss_names": loss_names(TASK_LOSS[task]), **kw})


def _pair(cfg):
    params, _ = init_vilt(jax.random.PRNGKey(0), cfg)
    model = ViLT(cfg)
    model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers).items()})
    return params, model


def _wire(cfg, B, seed=0):
    b = _fake_batch(cfg, B, seed=seed, image_dtype="uint8")
    return {k: b[k] for k in batch_spec(cfg, B)}


@pytest.mark.parametrize("task", TASKS)
def test_infer_fn_matches_jax(task):
    cfg = _cfg(task)
    params, model = _pair(cfg)
    b = _wire(cfg, 2)
    ref = jax_infer_fn(cfg, task)(params, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.inference_mode():
        ours = build_infer_fn(cfg, task)(model, {k: torch.from_numpy(v)
                                                 for k, v in b.items()})
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_session_chunks_and_pads_by_repeat():
    """5 requests through a batch-2 session (chunks 2, 2, 1+pad) equal each
    request served alone."""
    cfg = _cfg("vqa")
    _, model = _pair(cfg)
    b = _wire(cfg, 5, seed=1)
    out = Session(cfg, model, "vqa", 2, "cpu").infer(b)
    one = Session(cfg, model, "vqa", 1, "cpu")
    alone = np.concatenate([one.infer({k: v[i:i + 1] for k, v in b.items()})
                            for i in range(5)])
    assert out.shape == (5, cfg.vqav2_label_size)
    np.testing.assert_allclose(out, alone, atol=1e-6)


def test_cli_serve_matches_jax_records(tmp_path):
    """`python -m rmcl_tpu_torch.cli.run serve vqa` on PNGs, with the JAX
    weights converted and torch.saved, gives the records postprocess makes
    of the JAX package's outputs on the same requests."""
    from PIL import Image

    from rmcl_tpu.data.tokenizer import get_tokenizer, make_tiny_vocab
    from rmcl_tpu.serve import ArtifactSession, export_inference, export_meta, postprocess
    from rmcl_tpu_torch.cli.run import main

    vocab = make_tiny_vocab(str(tmp_path / "vocab.txt"), ["dog", "park", "the", "red"])
    cfg = _cfg("vqa", tokenizer=vocab)
    params, _ = init_vilt(jax.random.PRNGKey(0), cfg)
    ckpt = str(tmp_path / "vqa.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               state_dict_from_jax(params, cfg.num_layers).items()}},
               ckpt)
    r = np.random.RandomState(0)
    reqs, images, texts = [], [], []
    for i, (h, w) in enumerate([(40, 64), (64, 40), (30, 30)]):
        path = str(tmp_path / f"im{i}.png")
        Image.fromarray(r.randint(0, 256, (h, w, 3), np.uint8)).save(path)
        texts.append(["the red dog", "a dog in the park", "red"][i])
        reqs.append({"image": path, "text": texts[-1]})
        images.append(Image.open(path).convert("RGB"))
    inp, outp = str(tmp_path / "reqs.jsonl"), str(tmp_path / "out.jsonl")
    with open(inp, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in reqs)

    overrides = [f"{k}={v!r}" for k, v in TINY.items()]
    rc = main(["serve", "vqa", f"input={inp}", f"output={outp}", "batch_size=2",
               "device=cpu", "with", *overrides, "loss_names={'vqa': 1}",
               f"tokenizer={vocab}", f"load_path={ckpt}"])
    assert rc == 0
    with open(outp) as f:
        ours = [json.loads(ln) for ln in f]

    tok = get_tokenizer(vocab)
    sess = ArtifactSession(export_inference(cfg, params, "vqa", 2), params, tok,
                           export_meta(cfg, "vqa", 2))
    ref = postprocess("vqa", sess.predict(images, texts), tokenizer=tok)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert [j for j, _ in a["answers"]] == [j for j, _ in b["answers"]]
        np.testing.assert_allclose([p for _, p in a["answers"]],
                                   [p for _, p in b["answers"]], atol=1e-5)


_SESSION_RUN = (
    "import numpy as np\n"
    "from rmcl_tpu_torch import build_config, Session\n"
    "from rmcl_tpu_torch.serve import seeded_model\n"
    f"cfg = build_config(**{TINY!r}, loss_names={{'vqa': 1}})\n"
    "gh, gw = cfg.grid_hw\n"
    "r = np.random.RandomState(0)\n"
    "b = {'image': r.randint(0, 256, (3, gh * gw, 768)).astype(np.uint8),\n"
    "     'image_hw': np.array([[32, 48], [16, 32], [32, 16]], np.int32),\n"
    "     'text_ids': r.randint(1, 64, (3, 10)).astype(np.int32),\n"
    "     'text_masks': np.ones((3, 10), np.int32)}\n"
    "out = Session(cfg, seeded_model(cfg), 'vqa', 2, 'cpu').infer(b)\n"
    "assert out.shape == (3, 7) and np.isfinite(out).all()\n"
    "from rmcl_tpu_torch.serve import postprocess\n"
    "assert len(postprocess('vqa', out)) == 3\n")
_CLI_RUN = (   # raw requests: PNG, tokenizer, image pipeline, serve CLI
    "import json, numpy as np\n"
    "from PIL import Image\n"
    "from rmcl_tpu_torch.cli.run import main\n"
    "from rmcl_tpu_torch.data.tokenizer import make_tiny_vocab\n"
    "vocab = make_tiny_vocab('vocab.txt', ['red', 'dog'])\n"
    "Image.fromarray(np.full((40, 64, 3), 128, np.uint8)).save('im.png')\n"
    "with open('reqs.jsonl', 'w') as f:\n"
    "    f.write(json.dumps({'image': 'im.png', 'text': 'red dog'}) + '\\n')\n"
    f"args = [f'{{k}}={{v!r}}' for k, v in {TINY!r}.items()]\n"
    "assert main(['serve', 'vqa', 'input=reqs.jsonl', 'output=out.jsonl',\n"
    "             'device=cpu', 'with',\n"
    "             *args, \"loss_names={'vqa': 1}\", f'tokenizer={vocab}']) == 0\n"
    "with open('out.jsonl') as f:\n"
    "    assert len(f.readlines()) == 1\n")


_ARTIFACT_RUN = (   # the AOT artifact: export, load, serve wire batches
    "import numpy as np\n"
    "from rmcl_tpu_torch import build_config\n"
    "from rmcl_tpu_torch.serve import ArtifactSession, export_inference, export_meta, "
    "seeded_model\n"
    f"cfg = build_config(**{TINY!r}, loss_names={{'vqa': 1}})\n"
    "model = seeded_model(cfg)\n"
    "blob = export_inference(cfg, model, 'vqa', 2, device='cpu')\n"
    "gh, gw = cfg.grid_hw\n"
    "r = np.random.RandomState(0)\n"
    "b = {'image': r.randint(0, 256, (3, gh * gw, 768)).astype(np.uint8),\n"
    "     'image_hw': np.array([[32, 48], [16, 32], [32, 16]], np.int32),\n"
    "     'text_ids': r.randint(1, 64, (3, 10)).astype(np.int32),\n"
    "     'text_masks': np.ones((3, 10), np.int32)}\n"
    "sess = ArtifactSession(blob, model.state_dict(), None, export_meta(cfg, 'vqa', 2), 'cpu')\n"
    "out = sess.infer(b)\n"
    "assert out.shape == (3, 7) and np.isfinite(out).all()\n")


@pytest.mark.parametrize("run", [_SESSION_RUN, _CLI_RUN, _ARTIFACT_RUN],
                         ids=["session", "cli", "artifact"])
def test_port_never_imports_jax(run, tmp_path):
    code = (
        f"import sys\nsys.path.insert(0, {REPO!r})\n{run}"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rmcl_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "OK"


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
