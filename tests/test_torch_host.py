"""The port's own copies of the JAX package's jax-free host modules
(config, postprocess, parse_with, tokenizer, image transform, patch rows,
text buckets, the greedy attack's word filter), each held against its
original on the CPU, and the port's independence:
importing every module of rmcl_tpu_torch pulls in neither jax nor rmcl_tpu."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from rmcl_tpu.attacks import greedy as ref_greedy
from rmcl_tpu.cli.run import parse_with as ref_parse_with
from rmcl_tpu.core import buckets as ref_buckets
from rmcl_tpu.core import config as ref_config
from rmcl_tpu.data import tokenizer as ref_tokenizer
from rmcl_tpu.data import transforms as ref_transforms
from rmcl_tpu.data.arrow_dataset import _images_to_patch_rows, hwc_to_patch_rows
from rmcl_tpu.serve import postprocess as ref_postprocess
from rmcl_tpu_torch.attacks import greedy as port_greedy
from rmcl_tpu_torch.cli.run import parse_with
from rmcl_tpu_torch.core import buckets as port_buckets
from rmcl_tpu_torch.core import config as port_config
from rmcl_tpu_torch.data import patch_rows as port_rows
from rmcl_tpu_torch.data import tokenizer as port_tokenizer
from rmcl_tpu_torch.data import transforms as port_transforms
from rmcl_tpu_torch.serve import TASKS, postprocess
from tests._torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["dog", "park", "the", "red", "running", "unaffable"]


# ------------------------------------------------------------------ config
def test_config_dataclass_has_the_same_fields():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(port_config.RMCLConfig)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(ref_config.RMCLConfig)]
    assert ours == ref
    assert port_config.LOSS_KEYS == ref_config.LOSS_KEYS
    assert port_config.loss_names({"moco": 1}) == ref_config.loss_names({"moco": 1})
    assert port_config.named_configs() == ref_config.named_configs()
    assert port_config.VIT_PRESETS == ref_config.VIT_PRESETS


@pytest.mark.parametrize("name", sorted(ref_config.NAMED_CONFIGS))
def test_named_config_builds_to_equal_fields(name):
    ours, ref = port_config.build_config(name), ref_config.build_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("per_step_bs", "grid_hw", "num_patches", "image_seq_len", "seq_len"):
        assert getattr(ours, prop) == getattr(ref, prop)
    assert port_config.active_tasks(ours) == ref_config.active_tasks(ref)


def test_config_composition_and_overrides_match():
    args = ("task_moco", "step50k")
    kw = dict(vit="vit_large_patch16_384", image_bucket_hw=[224, 320], text_view=True)
    ours = port_config.build_config(*args, **kw).replace(seed=3)
    ref = ref_config.build_config(*args, **kw).replace(seed=3)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    with pytest.raises(KeyError):
        port_config.build_config("no_such_config")
    with pytest.raises(KeyError):
        port_config.build_config(vit="no_such_vit")


def test_parse_with_matches():
    argv = ["task_moco", "per_gpu_batchsize=16", "num_gpus=1", "image_bucket_hw=(384,608)",
            "load_path=/some/where.ckpt", "loss_names={'vqa': 1}", "text_view=True"]
    assert parse_with(argv) == ref_parse_with(argv)


# ------------------------------------------------------------------ buckets
def test_text_bucket_matches():
    assert port_buckets.TEXT_BUCKET_ALIGN == ref_buckets.TEXT_BUCKET_ALIGN
    for n in range(0, 50):
        for T in (8, 12, 24, 40):
            assert port_buckets.text_bucket(n, T) == ref_buckets.text_bucket(n, T)
    assert port_buckets.text_bucket(9, 40, align=4) == ref_buckets.text_bucket(9, 40, align=4)
    for over in ({}, {"greedy_text_bucket": False},
                 {"greedy_text_bucket": False, "attack_text_bucket": True},
                 {"attack_text_bucket": False}, {"eval_text_bucket": False}):
        c = port_config.build_config("task_moco", **over)
        for which in ("attack", "eval", "train"):
            assert (port_buckets.bucket_enabled(c, which)
                    == ref_buckets.bucket_enabled(ref_config.build_config("task_moco", **over),
                                                  which)), (over, which)


# ------------------------------------------------------ greedy word filter
def test_greedy_word_filter_matches():
    assert port_greedy.STOPWORDS == ref_greedy.STOPWORDS
    assert port_greedy.SPECIAL == ref_greedy.SPECIAL
    words = ["the", "The ", ",", "...", "", " ", "[CLS]", "[sep]", "dog", "Dog", "running",
             "a", "o", "!", "'", "unaffable", "ain", "CAT"]
    assert [port_greedy.check_word(w) for w in words] == [ref_greedy.check_word(w)
                                                          for w in words]


# ------------------------------------------------------------- postprocess
class _Tok:
    mask_token_id = 4

    def convert_ids_to_tokens(self, i):
        return f"tok{i}"


@pytest.mark.parametrize("task", TASKS)
def test_postprocess_matches(task):
    r = np.random.RandomState(0)
    shape = {"mlm": (3, 10, 17), "itm": (3, 2), "rank": (3,), "vqa": (3, 11),
             "embed": (3, 8)}[task]
    out = r.randn(*shape).astype(np.float32)
    ids = r.randint(0, 17, (3, 10))
    ids[:, 2], ids[1, 7] = 4, 4
    kw = dict(tokenizer=_Tok(), text_ids=ids) if task == "mlm" else {}
    assert postprocess(task, out, **kw) == ref_postprocess(task, out, **kw)


# --------------------------------------------------------------- tokenizer
def test_tokenizer_ids_match_on_a_tiny_vocab(tmp_path):
    v_ours = port_tokenizer.make_tiny_vocab(str(tmp_path / "a.txt"), WORDS)
    v_ref = ref_tokenizer.make_tiny_vocab(str(tmp_path / "b.txt"), WORDS)
    with open(v_ours) as f, open(v_ref) as g:
        assert f.read() == g.read()
    ours, ref = port_tokenizer.get_tokenizer(v_ours), ref_tokenizer.get_tokenizer(v_ref)
    texts = ["The red dog, running in the park!", "unaffable [MASK] dog",
             "café 中 dog", "x" * 120, ""]
    for t in texts:
        assert ours.tokenize(t) == ref.tokenize(t)
    a, b = ours(texts, max_length=12, return_tensors="np"), ref(texts, max_length=12,
                                                                return_tensors="np")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for x, y in zip(ours.batch_encode(texts[:2], 12), ref.batch_encode(texts[:2], 12)):
        np.testing.assert_array_equal(x, y)
    ids = a["input_ids"][0]
    assert ours.decode(ids) == ref.decode(ids)
    assert ours.mask_token_id == ref.mask_token_id and ours.vocab_size == ref.vocab_size


# ------------------------------------------------------- image pipeline
@pytest.mark.parametrize("hw", [(300, 500), (500, 300), (100, 420)])
@pytest.mark.parametrize("out_dtype", ["uint8", "float32"])
def test_pixelbert_transform_matches(hw, out_dtype):
    from PIL import Image
    img = Image.fromarray(np.random.RandomState(1).randint(0, 256, (*hw, 3), np.uint8))
    assert (port_transforms.min_max_size(hw[1], hw[0], 384, 640)
            == ref_transforms.min_max_size(hw[1], hw[0], 384, 640))
    kw = dict(size=96, bucket_hw=(96, 128), out_dtype=out_dtype)
    ours = port_transforms.pixelbert_transform(**kw)(img)
    ref = ref_transforms.pixelbert_transform(**kw)(img)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_patch_rows_match(dtype):
    r = np.random.RandomState(2)
    imgs = [(r.rand(h, w, 3) * 255).astype(dtype) for h, w in [(32, 48), (16, 32), (40, 60)]]
    ours = port_rows.images_to_patch_rows(imgs, 32, 48, 16)
    ref = _images_to_patch_rows(imgs, 32, 48, 16)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    canvas = (r.rand(2, 32, 48, 3) * 255).astype(dtype)
    np.testing.assert_array_equal(port_rows.hwc_to_patch_rows(canvas, 16),
                                  hwc_to_patch_rows(canvas, 16))


# ------------------------------------------------------------ independence
def test_importing_every_module_pulls_in_neither_jax_nor_rmcl_tpu(tmp_path):
    code = (
        f"import sys\nsys.path.insert(0, {REPO!r})\n"
        "import importlib, pkgutil\n"
        "import rmcl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rmcl_tpu_torch.__path__,\n"
        "                                               'rmcl_tpu_torch.')]\n"
        "assert len(names) > 15, names\n"
        "assert {'rmcl_tpu_torch.ops.philox', 'rmcl_tpu_torch.ops.fused_block_train',\n"
        "        'rmcl_tpu_torch.train.schedule', 'rmcl_tpu_torch.train.step',\n"
        "        'rmcl_tpu_torch.train.loop', 'rmcl_tpu_torch.core.buckets',\n"
        "        'rmcl_tpu_torch.attacks.greedy',\n"
        "        'rmcl_tpu_torch.attacks.greedy_fused',\n"
        "        'rmcl_tpu_torch.objectives.downstream', 'rmcl_tpu_torch.eval.vqa',\n"
        "        'rmcl_tpu_torch.eval.retrieval',\n"
        "        'rmcl_tpu_torch.data.vqa_glossary', 'rmcl_tpu_torch.data.augmentation',\n"
        "        'rmcl_tpu_torch.data.writers', 'rmcl_tpu_torch.data._native',\n"
        "        'rmcl_tpu_torch.objectives.moco_standalone',\n"
        "        'rmcl_tpu_torch.compat.timm', 'rmcl_tpu_torch.compat.golden',\n"
        "        'rmcl_tpu_torch.eval.tsne', 'rmcl_tpu_torch.demos.inference',\n"
        "        'rmcl_tpu_torch.demos.demo', 'rmcl_tpu_torch.demos.demo_vqa',\n"
        "        'rmcl_tpu_torch.parallel.comm', 'rmcl_tpu_torch.parallel.dist',\n"
        "        'rmcl_tpu_torch.parallel.mesh', 'rmcl_tpu_torch.parallel.tp',\n"
        "        'rmcl_tpu_torch.parallel.sharding_rules'} <= set(names)\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'rmcl_tpu'))\n"
        "assert not bad, bad\n"
        "# the card's machine has none of these: the modules import them where used\n"
        "host = {'PIL', 'pyarrow', 'sklearn', 'matplotlib', 'gradio'}\n"
        "assert not host & {m.split('.')[0] for m in sys.modules}, host & set(sys.modules)\n"
        "print('OK', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("OK")


def test_no_source_line_imports_the_jax_package():
    """No import statement of the port, of chip_smoke.py or of the port's
    rank script for the two-process tests names jax or rmcl_tpu (comments
    and strings may name a counterpart)."""
    import ast
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "_torch_ddp_worker.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rmcl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "rmcl_tpu"), (path, m)
