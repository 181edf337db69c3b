"""Gradient accumulation of the port's training step (train/step.py, accum >
1: the JAX package's optax MultiSteps) and the adam and sgd optimizers of
train/schedule.py against the JAX package on the CPU, at the tiny size of
tests/test_torch_train.py (2 layers, C = 32, queue 16 x 128).  The Trainer
that uses them is tests/test_torch_trainer.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _fake_batch
from rmcl_tpu.models.vilt import init_vilt
from rmcl_tpu.train import schedule as JS
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax, state_dict_from_jax
from rmcl_tpu_torch.train import schedule as TS
from rmcl_tpu_torch.train import step as TT
from tests.test_torch_train import (_cfg, _close_params, _jax_path, _jflat, _perturbed,
                                    _port_of, _t)
from tests._torch_threads import one_thread  # noqa: F401


# ------------------------------------------------------------ accumulation
def test_accum_two_matches_the_jax_step_at_accum_two():
    """Four micro-steps on two alternating batches at accum 2 against the
    JAX package's make_train_step(accum=2) (optax MultiSteps): mid-cycle
    the parameters do not move and the twins and the queue do; every leaf
    after every micro-step; lr indexed by step // accum (decaying over
    max_steps 4)."""
    cfg = _cfg(max_steps=4)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    batches = [_fake_batch(cfg, 4, seed=s, with_views=True) for s in (1, 2)]
    for b in batches:
        b.pop("text_labels")
    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=params,
                                            state=state, max_steps=4, accum=2)
    jstep = JT.make_train_step(cfg, jmodel, tx, donate=False, max_steps=4, accum=2)
    grad_fn = jax.jit(jax.grad(lambda p, s, b: JT.compute_all_tasks(
        cfg, jmodel, p, s, b, jax.random.PRNGKey(5), train=True)[0]))
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    # which elements are firm (_close_params): those of the first cycle's
    # mean gradient, the second micro-gradient taken after the first
    # micro-step moved the twins and the queue
    g0 = grad_fn(jts.params, jts.state, jbatches[0])
    g1 = grad_fn(jts.params, jstep(jts, jbatches[0], jax.random.PRNGKey(5))[0].state,
                 jbatches[1])
    jgrads = _jflat(jax.tree.map(lambda a, b: (a + b) / 2, g0, g1))
    ts = TT.create_train_state(cfg, max_steps=4, model=_port_of(cfg, params, state),
                               device="cpu", accum=2)
    step = TT.make_train_step(cfg, ts, max_steps=4)
    gen = torch.Generator().manual_seed(0)
    lr = TS.make_lr_schedule(cfg, 4)
    for it in range(4):
        b = batches[it % 2]
        before = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
        ptr0 = int(ts.model.proj_queue_ptr)
        jts, jmetrics = jstep(jts, jbatches[it % 2], jax.random.PRNGKey(5 + it))
        metrics = step({k: _t(v) for k, v in b.items()}, gen)
        for key in ("total_loss", "lr"):
            np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                       rtol=1e-4 if it == 0 else 2e-3, atol=1e-5,
                                       err_msg=f"micro-step {it} {key}")
        np.testing.assert_allclose(metrics["lr"].item(), lr(it // 2), rtol=1e-6)
        for n, p in ts.model.named_parameters():
            moved = not torch.equal(p, before[n])
            if n.startswith("k_"):
                assert moved, (it, n)
            elif it % 2 == 0:
                assert not moved, (it, n)            # mid-cycle: no update
        assert int(ts.model.proj_queue_ptr) == (ptr0 + 4) % 16
        want = {**_jflat(jts.params), **_jflat(jts.state)}
        _close_params(leaves_to_jax(ts.model), want,
                      {p: g for p, g in jgrads.items() if not p.startswith("k_")},
                      1e-3, f"micro-step {it}")
    assert lr(1) != lr(2) and ts.step == int(jts.step) == 4
    assert all(not a.any() for a in ts.acc_grads)


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_adam_and_sgd_steps_match_optax(optim):
    """Three updates on seeded gradients, warmup 2 (the first update has rate
    0), the head group at 10x: every leaf within 1e-6 of the JAX package's
    optax optimizer."""
    cfg = _cfg(warmup_steps=2, optim_type=optim)
    params, state = init_vilt(jax.random.PRNGKey(0), cfg)
    model = _port_of(cfg, params, state)
    tx, _ = JS.make_optimizer(cfg, params, 100)
    opt_state = tx.init(params)
    optimizer, scheduler, labels = TS.make_optimizer(cfg, model, 100)
    assert type(optimizer) is {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[optim]
    named = dict(model.named_parameters())
    for it in range(3):
        r = np.random.RandomState(10 + it)
        grads = jax.tree.map(lambda a: jnp.asarray(r.randn(*a.shape), a.dtype), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = state_dict_from_jax(grads, cfg.num_layers)
        for name, p in named.items():
            p.grad = torch.from_numpy(tgrads[name]) if labels[name] != TS.FROZEN else None
        optimizer.step()
        scheduler.step()
        ours, want = leaves_to_jax(model), _jflat(params)
        for path in want:
            np.testing.assert_allclose(ours[path], want[path], atol=1e-6, err_msg=path)
    assert {_jax_path(n, want) for n in labels} <= set(want)
    assert not np.allclose(ours["pooler/dense/kernel"],
                           _jflat(init_vilt(jax.random.PRNGKey(0), cfg)[0])["pooler/dense/kernel"])
