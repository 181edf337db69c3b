"""The pretraining tasks through the training entry points on the CPU, at
tests/test_torch_downstream_eval.py's sizes and arrow tables (its module
docstring), whose helpers these tests share:

  * the Trainer for task_mlm_itm (fit, one epoch of 2 steps, and its
    validation) against the JAX package's Trainer on the same weights and
    tables, the port fed the JAX package's ITM draws
    (tests/test_torch_pretrain.py:_replay, along the Trainer's keys): the
    steps' total_loss within 1e-5 relative, the epoch metrics within 2e-3
    relative, mlm_accuracy and itm_accuracy equal;
  * ``cli.run with`` task_mlm_itm, task_mlm_itm_mpp, task_mlm_itm_randaug and
    no named configuration (the default losses, itm and mlm), one
    fast_dev_run each on device=cpu;
  * load_initial_params grafting the MLM / ITM heads from a synthetic
    models_weight/vilt_200k_mlm_itm.ckpt onto a synthetic load_path, as the
    JAX package's load_initial_params does, for task_mlm_itm and for
    task_finetune_irtr_coco (itm at 0.5): the heads equal the JAX
    package's, and without the file nothing is grafted."""

import os

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
from rmcl_tpu_torch.train import step as TT
from tests.test_torch_downstream import _moved
from tests.test_torch_downstream_eval import (_kw, _records, _same_epoch, _same_steps,  # noqa: F401
                                              _trainers, data)
from tests.test_torch_pretrain import _replay
from tests.test_torch_train import _jflat
from tests._torch_threads import one_thread  # noqa: F401


def _feed_jax_draws(monkeypatch, cfg, n_steps, n_val):
    """The port's pretrain_draws replaced by the JAX Trainer's draws: its
    steps' keys fold_in(PRNGKey(seed + 1), n), then its validation's, split
    one by one from PRNGKey(seed + 2)."""
    keys = [jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), n) for n in range(n_steps)]
    rng = jax.random.PRNGKey(cfg.seed + 2)
    for _ in range(n_val):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    keys = iter(keys)
    monkeypatch.setattr(TT, "pretrain_draws", lambda cfg_, gen, batch, n_patches, device:
                        _replay(cfg_, next(keys), n_patches, batch))


def test_mlm_itm_trainer_matches_the_jax_trainer(data, tmp_path, monkeypatch):
    """task_mlm_itm (batch 2, the coco tables): fit, one epoch of 2 steps, and
    its validation over the 3 test images as the module docstring says."""
    jtr, tr = _trainers(data, tmp_path, "task_mlm_itm", datasets=("coco",))
    _feed_jax_draws(monkeypatch, tr.cfg, 2, 2)
    jtr.fit()
    tr.fit()
    ours, ref = _records(tr.workdir), _records(jtr.workdir)
    _same_steps(ours, ref)
    epoch = _same_epoch(ours, ref, 2e-3)
    jepoch = [r for r in ref if "val_epoch/mlm_accuracy" in r][0]
    for k in ("val_epoch/mlm_accuracy", "val_epoch/itm_accuracy"):
        assert epoch[k] == jepoch[k], k
        assert 0.0 <= epoch[k] <= 1.0


@pytest.mark.parametrize("config", ["task_mlm_itm", "task_mlm_itm_mpp",
                                    "task_mlm_itm_randaug", ""])
def test_cli_runs_the_pretraining_configs_on_the_cpu(data, tmp_path, capsys, config):
    """``cli.run with <config> datasets=['coco'] ... device=cpu`` (the coco
    tables only): one step, validation and the checkpoint; "" is the bare
    ``with`` of the default losses."""
    from rmcl_tpu_torch.cli.run import main
    d, vocab, _ = data
    kw = _kw(d, vocab, log_dir=str(tmp_path / "log"), max_steps=1, fast_dev_run=True,
             datasets=["coco"])
    args = ["with"] + ([config] if config else []) + [
        f"{k}={v}".replace(" ", "") for k, v in kw.items()] + ["device=cpu"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "val/the_metric" in out and "\nitm_accuracy: " in out and "\nmlm_accuracy: " in out
    assert ("\nmpp_accuracy: " in out) == (config == "task_mlm_itm_mpp")


# ------------------------------------------------------------- the graft
def _write(path, sd):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}}, path)


@pytest.mark.parametrize("config", ["task_mlm_itm", "task_finetune_irtr_coco"])
def test_load_initial_params_grafts_the_heads_as_jax(data, tmp_path, monkeypatch, config):
    """A synthetic load_path (the weights of one seed) and a synthetic
    models_weight/vilt_200k_mlm_itm.ckpt (another seed's heads), in the working
    directory: the port's loaded mlm_score / itm_score equal what the JAX
    package's load_initial_params loads, grafted where its loss weight is
    > 0; without the file, the load_path's own."""
    d, vocab, _ = data
    kw = _kw(d, vocab, load_path=str(tmp_path / "weights.ckpt"))
    jcfg = jax_build_config(config, **kw)
    cfg = build_config(config, **kw)
    base, state = init_vilt(jax.random.PRNGKey(0), jcfg)
    base = _moved(base)
    heads, _ = init_vilt(jax.random.PRNGKey(1), jax_build_config("task_mlm_itm", **kw))
    heads = _moved(heads, seed=4)
    _write(kw["load_path"], state_dict_from_jax(base, cfg.num_layers))
    pre = {k: v for k, v in state_dict_from_jax(heads, cfg.num_layers).items()
           if k.startswith(("mlm_score.", "itm_score."))}
    monkeypatch.chdir(tmp_path)
    grafted = [h for h, loss in (("mlm_score", "mlm"), ("itm_score", "itm"))
               if cfg.loss_names.get(loss, 0) > 0]
    assert grafted == (["mlm_score", "itm_score"] if config == "task_mlm_itm"
                       else ["itm_score"])
    for with_file in (False, True):
        if with_file:
            _write("models_weight/vilt_200k_mlm_itm.ckpt", pre)
        jparams, _ = JL.load_initial_params(jcfg, *init_vilt(jax.random.PRNGKey(2), jcfg))
        want = _jflat(jparams)
        ours = leaves_to_jax(TC.load_initial_params(
            cfg, ViLT(cfg).init(torch.Generator().manual_seed(2))))
        source = _jflat(heads) if with_file else _jflat(base)
        for path, a in ours.items():
            if path.split("/")[0] in ("mlm_score", "itm_score"):
                assert np.array_equal(a, want[path]), (with_file, path)
                own = path.split("/")[0] in grafted and with_file
                assert np.array_equal(a, (source if own else _jflat(base))[path]), path
