"""Learning tests of the port (``tests/test_convergence.py``'s, on
``rmcl_tpu_torch/train/step.py:make_train_step``): the training system must
learn, not only run.  One fixed batch, trained for many steps at the JAX
file's tiny configuration (``_tiny``), learning rates, step counts and
criteria (``_trend``): a negated loss, a mis-scaled gradient or an EMA that
overwrites the query net computes finite losses that never fall.

Every run starts from the JAX package's initial weights carried across
(``compat/from_jax.py``), and for the JAX file's five families the first
``PARITY_STEPS`` losses must equal the JAX step's within 1e-5 relative
(fp32 summation order, compounded over the steps' AdamW updates), but for
BarlowTwins, held to BT_PARITY_RTOL = 1e-3: at initialisation its head's
BatchNorms divide by a spread of ~1e-5 of the feature over 8 nearly equal
rows, so both packages compute the loss from rounding noise
(``tests/test_torch_barlowtwins.py``'s docstring); measured 1.2e-5, 2.0e-4
and 6.1e-5 over the three steps.  This file holds MLM, VQA and NLVR2; ``test_torch_convergence_bt.py`` BarlowTwins,
``test_torch_convergence_moco.py`` MoCo, ``test_torch_convergence_ranking.py``
the two families the JAX file never covered, IRTR and ITM (each file under
~45 s alone).

The seven families (configuration overrides, pairs, batch, criteria and
parity tolerance) are defined once, in ``chip_smoke.py`` (``LEARN_FAMILIES``,
``learn_batch``), which runs them on the card's kernels too and imports no
JAX; ``test_learning_families_are_the_jax_files`` holds that definition to
the JAX file's ``_tiny`` and ``_trend`` and to ``make_fake_batch``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.train import step as TT
from tests.conftest import make_fake_batch
from tests.test_convergence import _tiny as tiny
from tests.test_convergence import _trend as trend
from tests.test_torch_train import _port_of
from tests._torch_threads import one_thread  # noqa: F401

PARITY_STEPS = 3
PARITY_RTOL = 1e-5
BT_PARITY_RTOL = 1e-3


def _jax_losses(cfg, batch, n_steps, seed=0):
    """The JAX package's ``_run`` for ``n_steps``: its initial parameters and
    model state, and the per-step scalar metrics."""
    model, ts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg)
    params, state = ts.params, ts.state
    step_fn = JT.make_train_step(cfg, model, tx, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    history, rng = [], jax.random.PRNGKey(seed)
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        ts, metrics = step_fn(ts, jbatch, sub)
        history.append({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
    return params, state, history


def port_run(cfg, batch, n_steps, params, state, seed=0, device="cpu"):
    """The port's ``make_train_step`` for ``n_steps`` on the one batch from
    the given JAX weights: the per-step scalar metrics."""
    ts = TT.create_train_state(cfg, model=_port_of(cfg, params, state), device=device)
    step = TT.make_train_step(cfg, ts)
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(seed)
    history = []
    for _ in range(n_steps):
        metrics = step(tbatch, gen)
        history.append({k: v.item() for k, v in metrics.items() if v.dim() == 0})
    return history


def learn(cfg, batch, n_steps, keys, parity=True, rtol=PARITY_RTOL):
    """The port's run of ``n_steps``; with ``parity`` its first
    ``PARITY_STEPS`` values of every key in ``keys`` against the JAX step's
    within ``rtol``, else the JAX package's initial weights only."""
    if parity:
        params, state, ref = _jax_losses(cfg, batch, PARITY_STEPS)
    else:
        model, ts, _ = JT.create_train_state(jax.random.PRNGKey(0), cfg)
        params, state, ref = ts.params, ts.state, []
    history = port_run(cfg, batch, n_steps, params, state)
    for it, want in enumerate(ref):
        for key in keys:
            got = history[it][key]
            assert abs(got - want[key]) <= rtol * abs(want[key]), (it, key, got, want[key])
    return history


def family_config(family):
    """The JAX package's configuration of ``family``: the JAX file's
    ``_tiny`` with ``chip_smoke.LEARN_FAMILIES``'s overrides, the one
    definition of the seven families that phase 20 runs on the card too
    (``test_learning_families_are_the_jax_files`` holds it to the JAX
    file's helpers)."""
    losses, overrides = CS.LEARN_FAMILIES[family][:2]
    return tiny(losses, **overrides)


def learn_family(family, keys=None, parity=True):
    """``family``'s run of ``chip_smoke.LEARN_STEPS`` steps on
    ``chip_smoke.learn_batch``, held to its ``LEARN_FAMILIES`` criteria
    through the JAX file's ``_trend`` and, where ``ACCURACY`` names one, a
    step accuracy of at least 0.99 over the last five; with ``parity`` the
    first ``PARITY_STEPS`` values of ``keys`` (default: the first criterion's)
    against the JAX step's within the family's tolerance."""
    _, _, _, trends, rtol = CS.LEARN_FAMILIES[family]
    cfg = family_config(family)
    history = learn(cfg, CS.learn_batch(family, cfg), CS.LEARN_STEPS,
                    keys or (trends[0][0],), parity=parity, rtol=rtol)
    for key, factor, vs in trends:
        trend(history, key, factor, vs=vs)
    if family in CS.ACCURACY:
        acc = [h[CS.ACCURACY[family]] for h in history]
        assert float(np.mean(acc[-5:])) >= 0.99, acc
    return history


def test_mlm_overfit():
    """MLM on one fixed masked batch must overfit hard (vocab 64); JAX
    measured 4.22 -> 0.017 over 60 steps at lr 5e-3."""
    learn_family("mlm")


def test_vqa_overfit():
    """VQA BCE to fixed soft targets must decrease steadily (JAX: 5.43 ->
    0.21 over 60 steps; the soft 0.3-score target keeps an irreducible BCE
    term)."""
    learn_family("vqa")


def test_nlvr2_overfit():
    """NLVR2 CE on a fixed two-image batch must overfit to chance-free
    accuracy (reference compute_nlvr2, objectives.py:1002-1060)."""
    learn_family("nlvr2")


@pytest.mark.parametrize("family", list(CS.LEARN_FAMILIES))
def test_learning_families_are_the_jax_files(family):
    """chip_smoke.py's definition of a family against the JAX file's
    helpers: its port configuration (``LEARN_TINY`` and the overrides) equals
    ``_tiny``'s field for field, its ``fake_batch`` is
    ``tests/conftest.py:make_fake_batch`` at every seed ``learn_batch``
    draws, ``check_trend`` passes and fails where ``_trend`` does, and the
    parity tolerance is this file's (PARITY_RTOL, BT_PARITY_RTOL)."""
    assert CS.LEARN_FAMILIES[family][4] == (BT_PARITY_RTOL if family == "barlowtwins"
                                            else PARITY_RTOL)
    assert CS.LEARN_STEPS == 60 and CS.LEARN_PARITY == PARITY_STEPS
    want, got = family_config(family), CS.learn_config(family)
    fields = {f.name for f in dataclasses.fields(got)}
    assert fields <= {f.name for f in dataclasses.fields(want)}
    for name in sorted(fields):
        assert getattr(got, name) == getattr(want, name), name
    n = CS.LEARN_FAMILIES[family][2]
    for seed in (0, 3, 10, 11, 12):
        ref = make_fake_batch(want, batch=n, seed=seed)
        ours = CS.fake_batch(want, n, seed)
        assert set(ours) == set(ref)
        for key, value in ref.items():
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
    for key, factor, vs in CS.LEARN_FAMILIES[family][3]:
        for losses in ([4.0, 5.0, 1.0, 0.1, 0.1, 0.1, 0.1, 0.1], [4.0, 5.0, 3.0, 3.0, 3.0,
                                                                   3.0, 3.0, 3.0],
                       [4.0, 3.0, 2.0, 1.9, 1.8, 1.9, 2.0, 2.1], [1.0, float("nan")] * 4):
            history = [{key: v} for v in losses]
            try:
                trend(history, key, factor, vs=vs)
                jax_held = True
            except AssertionError:
                jax_held = False
            try:
                CS.check_trend(family, history, key, factor, vs)
                held = True
            except CS.SmokeFailure:
                held = False
            assert held == jax_held, (key, factor, vs, losses)


