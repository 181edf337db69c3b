"""Configurations P and F under a model axis (models/vit.py:Block), on the
CPU: two gloo ranks of tests/_torch_ddp_worker.py on a (1, 2) grid run two
task_moco steps (tests/test_train.py's tiny model: hidden 32, 2 heads, so
one head a shard; 8 pairs) at drop_rate 0.1 in fp32, configuration P
(``attention_impl="pallas"``: the unfused attention around
``masked_attention`` on the shard's heads) and F (``attention_impl="fused",
mlp_impl="fused"``: ``attn_half_full`` and the plain MLP), while this process
runs the port's one-process step of the same configuration on the same
weights and seeds, the reference that tests/test_torch_impls.py holds to
the JAX package.  Per step: the loss within 1e-5 relative; every gathered
gradient within 2e-4 x max(1, max|ref|) (the shards' partial products are
summed in another order than the unsharded ones, and the MoCo loss divides
by a temperature of 0.07); every rank's in-MLP keep masks the one-process
masks' columns of its shard, bit for bit; the replicated entries the same
bits on both ranks.

At drop_rate 0 the ranks' step of each configuration is also held to the JAX
package's ``make_train_step`` of that configuration (config F's Pallas
kernels in interpret mode) on the same weights and batch, as
tests/test_torch_tp.py holds the default configuration: the metrics (the loss
within rtol 1e-5, the rest 1e-4) and every gathered leaf after the step
(``_close_params``: 2% of the rate where the gradient is firm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rmcl_tpu.models.vilt import ViLTModel
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from tests._torch_ddp_worker import port_cfg, run_steps, start_ranks
from tests._torch_threads import one_thread  # noqa: F401
from tests.conftest import make_fake_batch
from tests.test_torch_ddp import close_metrics
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests.test_train import _tiny

IMPLS = {"P": dict(attention_impl="pallas"), "F": dict(attention_impl="fused", mlp_impl="fused")}
GRAD_RTOL = 2e-4


def _jcfg(**kw):
    return _tiny({"moco": 1}, num_negative=16, momentum=0.99, temperature=0.07,
                 warmup_steps=0, **kw)


def _jax_step(name, params, state, batch):
    """One step of the JAX package's ``make_train_step`` under configuration
    ``name``: (its metrics, every leaf after it)."""
    jcfg = _jcfg(**IMPLS[name])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RMCL_PALLAS_INTERPRET", "1")
        jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), jcfg, params=params,
                                                state=state)
        jts, jm = JT.make_train_step(jcfg, jmodel, tx, donate=False)(
            jts, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(5))
        return {k: float(v) for k, v in jm.items()}, {**_jflat(jts.params), **_jflat(jts.state)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_impls")
    jcfg = _jcfg()
    params, state = ViLTModel(jcfg).init(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    sd = _port_of(jcfg, params, state).state_dict()
    b = make_fake_batch(jcfg, batch=8)
    batch = {"image": hwc_to_patch_rows(b["image"], jcfg.patch_size),
             "text_ids": b["text_ids"].astype(np.int32),
             "text_masks": b["text_masks"].astype(np.int32)}
    cases = {name: dict(cfg=port_cfg(jcfg, drop_rate=0.1, **kw), state_dict=sd,
                        batches=[batch, batch], seed=0) for name, kw in IMPLS.items()}
    cases.update({f"{name}0": dict(cfg=port_cfg(jcfg, **kw), state_dict=sd, batches=[batch],
                                   seed=0) for name, kw in IMPLS.items()})
    ranks = start_ranks({"case": "steps", "runs": list(cases.values()),
                         "grid": ((1, 2), ("data", "model"))}, d, world=2)
    one = {name: run_steps(cases[name]) for name in IMPLS}
    jax_steps = {name: _jax_step(name, params, state, batch) for name in IMPLS}
    got = ranks.result()
    out = {name: (one.get(name), [r[i] for r in got]) for i, name in enumerate(cases)}
    return dict(out, jax=jax_steps, lr=jcfg.learning_rate)


@pytest.mark.parametrize("name", list(IMPLS))
def test_p_and_f_on_a_model_axis_match_one_process(runs, name):
    one, ranks = runs[name]
    assert [r["grid"] for r in ranks] == [(0, 0), (0, 1)]
    assert ranks[0]["replicated"] == ranks[1]["replicated"]
    for r in ranks:
        for it in range(2):
            np.testing.assert_allclose(r["metrics"][it]["moco_loss"],
                                       one["metrics"][it]["moco_loss"], rtol=1e-5)
            assert set(r["grads"][it]) == set(one["grads"][it])
            for path, g in r["grads"][it].items():
                _close(f"{name} rank {r['grid']} step {it} grad {path}", g,
                       one["grads"][it][path], GRAD_RTOL)
        j = r["grid"][1]
        assert len(r["mlp_masks"]) == len(one["mlp_masks"]) > 0
        for mask, ref in zip(r["mlp_masks"], one["mlp_masks"]):
            n = mask.shape[-1]
            assert 2 * n == ref.shape[-1]
            np.testing.assert_array_equal(mask, ref[..., j * n:(j + 1) * n])
    assert not all(m.all() for m in one["mlp_masks"])      # dropout was on


@pytest.mark.parametrize("name", list(IMPLS))
def test_p_and_f_on_a_model_axis_match_jax(runs, name):
    """drop_rate 0: both ranks' step of the configuration against the JAX
    package's step of it on the same weights and batch."""
    jm, want = runs["jax"][name]
    _, ranks = runs[f"{name}0"]
    assert [r["grid"] for r in ranks] == [(0, 0), (0, 1)]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["replicated"] == ranks[1]["replicated"]
    np.testing.assert_allclose(ranks[0]["metrics"][0]["moco_loss"], jm["moco_loss"], rtol=1e-5)
    close_metrics(ranks[0]["metrics"][0], jm, 1e-4, f"{name} step 0")
    for r in ranks:
        firm = {p: g for p, g in r["grads"][0].items() if not p.startswith("k_")}
        _close_params(r["leaves"][0], want, firm, runs["lr"], f"{name} rank {r['grid']}")
