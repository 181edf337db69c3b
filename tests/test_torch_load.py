"""load_path from a checkpoint of another task: the port's
``train/checkpoint.py:load_initial_params`` (through
``ViLT.load_reference_state_dict``) against the JAX package's
``rmcl_tpu/train/loop.py:load_initial_params``, which converts a torch file
(``rmcl_tpu/compat/torch_loader.py:convert_state_dict``) and merges it into
the fresh init.

The file is a synthetic ``task_mlm_itm`` checkpoint: the JAX package's init
of that task at C = 32, 2 layers, every leaf moved by seeded numpy noise, in
reference names (``compat/from_jax.py:state_dict_from_jax``).  Each target
model starts from the JAX package's init of its own task, carried into the
port through the same names, so that the parts the file lacks (the task's
head, the momentum twins, the queue) can be compared; both packages then
load the file.  Every parameter and buffer of the port must equal the JAX
package's merged tree exactly, but for a resized pos-embed: the same fp32
weights of ``jax.image.resize``'s bilinear kernel (antialiased when it
shrinks), summed over at most 3 x 3 taps in another order, within 1e-6 of
max |ref| (a few fp32 ulps).  A misshapen entry that the JAX package does
not repair raises in the port, naming it.
"""

import jax
import numpy as np
import pytest
import torch

from rmcl_tpu.core.config import build_config as jax_build_config
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.train import loop as JL
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax, state_dict_from_jax
from rmcl_tpu_torch.core.config import build_config
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.train import checkpoint as TC
from tests.test_torch_downstream import _moved
from tests.test_torch_train import _jflat
from tests._torch_threads import one_thread  # noqa: F401

SMALL = dict(hidden_size=32, num_heads=2, num_layers=2, patch_size=16, image_size=192,
             max_text_len=10, vocab_size=64, vqav2_label_size=7, num_negative=16,
             bt_proj_dims=(64, 64, 64), compute_dtype="float32", drop_rate=0.0)
# case -> (target task, target overrides, the file's overrides)
CASES = {
    "vqa": ("task_finetune_vqa", {}, {}),
    "irtr": ("task_finetune_irtr_coco", {}, {}),
    "moco": ("task_moco", {}, {}),
    "barlowtwins": ("task_barlowtwins", {}, {}),
    "nlvr2": ("task_finetune_nlvr2", {}, {}),
    "pos_embed_grow": ("task_finetune_vqa", {"image_size": 224}, {}),       # 12 x 12 -> 14 x 14
    "pos_embed_shrink": ("task_moco", {}, {"image_size": 224}),             # 14 x 14 -> 12 x 12
    "misshapen": ("task_finetune_vqa", {}, {"vocab_size": 70}),
}
RESIZE_TOL = 1e-6


def _write_file(path, overrides):
    jcfg = jax_build_config("task_mlm_itm", **dict(SMALL, **overrides))
    params, _ = init_vilt(jax.random.PRNGKey(0), jcfg)
    sd = state_dict_from_jax(_moved(params, seed=5), jcfg.num_layers)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return sd


def _port_tree(model):
    """The port's parameters and running statistics under the JAX paths, and
    its queue state as the JAX package's state keys."""
    tree = leaves_to_jax(model)
    for name in ("proj_queue", "proj_queue_ptr"):
        tree.pop(name, None)
        if hasattr(model, name):
            tree["state/" + name] = getattr(model, name).float().numpy().reshape(
                getattr(model, name).shape if name == "proj_queue" else ())
    return tree


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_path_of_another_task_matches_jax(case, tmp_path, monkeypatch):
    task, target_kw, file_kw = CASES[case]
    monkeypatch.chdir(tmp_path)          # no models_weight/ here: nothing is grafted
    path = str(tmp_path / "vilt_mlm_itm.ckpt")
    file_sd = _write_file(path, file_kw)
    kw = dict(SMALL, **target_kw, load_path=path)
    jcfg, cfg = jax_build_config(task, **kw), build_config(task, **kw)
    params, state = init_vilt(jax.random.PRNGKey(2), jcfg)
    model = ViLT(cfg)
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers, state).items()}) == []
    if case == "misshapen":
        # the JAX package merges a 70-row word embedding into a model of 64
        # words without a word; the port refuses it
        with pytest.raises(ValueError, match="text_embeddings.word_embeddings.weight"):
            TC.load_initial_params(cfg, model)
        return
    jparams, jstate = JL.load_initial_params(jcfg, params, state)
    ours = _port_tree(TC.load_initial_params(cfg, model))
    want = _jflat(jparams)
    want.update({"state/" + k: np.asarray(v, np.float32) for k, v in jstate.items()})
    # the JAX tree also holds the file's parts the target does not build,
    # which the port skips
    assert set(ours) <= set(want)
    assert all(p.split("/")[0] in ("mlm_score", "itm_score") and not hasattr(model, p.split("/")[0])
               for p in set(want) - set(ours))
    resized = {p for p in want if p.endswith("transformer/pos_embed")} if file_kw.get(
        "image_size") or target_kw.get("image_size") else set()
    for p, ref in ((p, want[p]) for p in ours):
        assert ours[p].shape == ref.shape, p
        if p in resized:
            err = np.abs(ours[p] - ref).max()
            assert err <= RESIZE_TOL * np.abs(ref).max(), (p, err)
        else:
            np.testing.assert_array_equal(ours[p], ref, err_msg=p)
    # what came from the file and what kept its init
    flat_init = _jflat(params)
    head = {"vqa": "vqa_classifier", "irtr": "rank_output", "moco": "moco_head",
            "barlowtwins": "barlowtwins_head", "nlvr2": "nlvr2_classifier",
            "pos_embed_grow": "vqa_classifier", "pos_embed_shrink": "k_transformer"}[case]
    kept = [p for p in ours if p.startswith(head + "/")]
    assert kept and all(np.array_equal(ours[p], flat_init[p]) for p in kept), head
    loaded = np.asarray(file_sd["pooler.dense.weight"]).T
    assert np.array_equal(ours["pooler/dense/kernel"], loaded)
    if case == "nlvr2":                  # 2 rows in the file, the third repeats the second
        tte = ours["token_type_embeddings/weight"]
        assert tte.shape[0] == 3 and np.array_equal(tte[2], tte[1])
        assert np.array_equal(tte[:2], file_sd["token_type_embeddings.weight"])
    if resized:
        assert ours["transformer/pos_embed"].shape[1] == (cfg.image_size // 16) ** 2 + 1

