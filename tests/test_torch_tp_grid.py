"""The port's tensor parallelism over larger grids, on the CPU (gloo ranks of
tests/_torch_ddp_worker.py under torchrun, started together while this
process computes the references):

  * task_moco + MLM (tests/test_train.py:195's configuration: hidden 32, 2
    heads, vocabulary 64, 8 pairs, MLM labels at one position) on a (1, 2)
    grid against the JAX package's ``make_train_step``, two steps: the
    vocabulary-parallel decoder, whose logits the model group gathers.  The
    tolerances of tests/test_torch_ddp.py: the loss within rtol 1e-5, the
    metrics within rtol 1e-4 / atol 1e-5 at step one and 2e-3 at step two,
    every gathered leaf by ``_close_params``.
  * The attacked task_moco step at drop_rate 0.1 on a (2, 2) grid (four
    ranks, 2 pairs per data rank) against the port's one-process step on the
    4 pairs, which draws the same masks: the same tolerances, the gradient
    the optimizer took within 1e-5 x max(1, max|ref|), the attacked ids
    exact; every in-MLP keep mask of a rank the one-process mask's rows of its
    data rank and columns of its model rank, bit for bit (the column
    offset); the replicated leaves and their AdamW moments the same bits on
    every rank of a model group after each step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import ViLTModel
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from tests._torch_ddp_worker import port_cfg, run_steps, start_ranks
from tests._torch_threads import one_thread  # noqa: F401
from tests.conftest import make_fake_batch
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_ddp import close_metrics
from tests.test_torch_greedy import SENTENCES, _batch, _step_cfg, _write_vectors
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests.test_train import _tiny

AXES = ("data", "model")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_grid")
    # task_moco + MLM: the JAX step here, two ranks of a (1, 2) grid
    mcfg = _tiny({"moco": 1, "mlm": 1}, num_negative=16, momentum=0.99, temperature=0.07,
                 warmup_steps=0)
    params, state = ViLTModel(mcfg).init(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    b = make_fake_batch(mcfg, batch=8)
    labels = np.full_like(b["text_ids"], -100)
    labels[:, 2] = b["text_ids"][:, 2]
    mbatch = {"image": hwc_to_patch_rows(b["image"], mcfg.patch_size),
              "text_ids": b["text_ids"].astype(np.int32),
              "text_masks": b["text_masks"].astype(np.int32),
              "text_ids_mlm": b["text_ids"].astype(np.int32),
              "text_labels_mlm": labels.astype(np.int32)}
    mlm_run = dict(cfg=port_cfg(mcfg), state_dict=_port_of(mcfg, params, state).state_dict(),
                   batches=[mbatch, mbatch], seed=0)
    mlm_ranks = start_ranks({"case": "steps", "runs": [mlm_run], "grid": ((1, 2), AXES)},
                            d, world=2)
    # the attacked step at drop_rate 0.1: four ranks of a (2, 2) grid
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    vectors = _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)
    jtok = JTokenizer(vocab)
    acfg = _step_cfg(jtok.vocab_size)
    aparams, astate = ViLTModel(acfg).init(jax.random.PRNGKey(0))
    aparams = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in aparams.items()}
    att_run = dict(cfg=port_cfg(acfg, drop_rate=0.1),
                   state_dict=_port_of(acfg, aparams, astate).state_dict(),
                   batches=[_batch(acfg, jtok, SENTENCES["four"])] * 2,
                   attack=(vocab, vectors), seed=0)
    att_ranks = start_ranks({"case": "steps", "runs": [att_run], "grid": ((2, 2), AXES)},
                            d, world=4)

    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), mcfg, params=params,
                                            state=state)
    jstep = JT.make_train_step(mcfg, jmodel, tx, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in mbatch.items()}
    jsteps = []
    for it in range(2):
        jts, jm = jstep(jts, jbatch, jax.random.PRNGKey(7 + it))
        jsteps.append(({k: float(v) for k, v in jm.items()},
                       {**_jflat(jts.params), **_jflat(jts.state)}))
    one = run_steps(att_run)
    return dict(mcfg=mcfg, jsteps=jsteps, mlm=[r[0] for r in mlm_ranks.result()],
                acfg=acfg, one=one, att=[r[0] for r in att_ranks.result()])


def test_moco_mlm_step_on_a_model_axis_matches_jax(runs):
    """Two task_moco + MLM steps of a (1, 2) grid against the JAX package's
    step on the 8 pairs: the MLM loss and accuracy, every metric, every
    gathered leaf (the decoder's rows gathered from both ranks) after each
    step; the replicated leaves the same bits on both ranks."""
    r0, r1 = runs["mlm"]
    assert (r0["grid"], r1["grid"]) == ((0, 0), (0, 1))
    assert r0["replicated"] == r1["replicated"] and r0["metrics"] == r1["metrics"]
    jm0 = runs["jsteps"][0][0]
    assert r0["metrics"][0]["mlm_loss"] > 0
    np.testing.assert_allclose(r0["metrics"][0]["mlm_loss"], jm0["mlm_loss"], rtol=1e-5)
    for it, (jm, want) in enumerate(runs["jsteps"]):
        close_metrics(r0["metrics"][it], jm, 1e-4 if it == 0 else 2e-3, f"step {it}")
        firm = {p: g for p, g in r0["grads"][0].items() if not p.startswith("k_")}
        for r in (r0, r1):
            assert set(r["leaves"][it]) == set(want)
            _close_params(r["leaves"][it], want, firm, runs["mcfg"].learning_rate,
                          f"step {it}")
    assert r0["leaves"][0]["mlm_score/decoder/kernel"].shape == (32, 64)


def test_four_ranks_with_dropout_match_one_process(runs):
    """A (2, 2) grid at drop_rate 0.1 against the port's one-process step on
    the 4 pairs: metrics, gradients, leaves and ids; every rank's in-MLP masks
    the one-process masks' rows and columns; the replicated state the same
    bits across each model group; the sharded state not."""
    one, ranks = runs["one"], runs["att"]
    assert [r["grid"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    b = 2                                      # pairs per data rank
    for r in ranks:
        i, j = r["grid"]
        for it in range(2):
            np.testing.assert_allclose(r["metrics"][it]["moco_loss"],
                                       one["metrics"][it]["moco_loss"], rtol=1e-5)
            close_metrics(r["metrics"][it], one["metrics"][it], 1e-4, f"{r['grid']} step {it}")
            for path, g in r["grads"][it].items():
                _close(f"{r['grid']} step {it} grad {path}", g, one["grads"][it][path])
            _close_params(r["leaves"][it], one["leaves"][it],
                          {p: g for p, g in one["grads"][0].items() if not p.startswith("k_")},
                          runs["acfg"].learning_rate, f"{r['grid']} step {it}")
        for a, ref in zip(r["ids"], one["ids"]):
            np.testing.assert_array_equal(a, ref[i * b:(i + 1) * b])
        assert len(r["mlp_masks"]) == len(one["mlp_masks"]) > 0
        for mask, ref in zip(r["mlp_masks"], one["mlp_masks"]):
            n = mask.shape[-1]
            np.testing.assert_array_equal(mask, ref[i * b:(i + 1) * b, :, j * n:(j + 1) * n])
    for i in (0, 1):
        assert ranks[2 * i]["replicated"] == ranks[2 * i + 1]["replicated"]
        assert ranks[2 * i]["hash"][0] != ranks[2 * i + 1]["hash"][0]
    # dropout was on
    assert not all(m.all() for m in one["mlp_masks"])
