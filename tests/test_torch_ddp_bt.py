"""The port's batch-coupled steps over two gloo processes on the CPU:

  * the attacked task_barlowtwins step of 2 ranks x 2 pairs, whose head
    (its BatchNorm statistics), correlation loss, PGD and greedy attack read
    every rank's rows, against the JAX package's make_attacked_train_step on
    the 4 pairs and its gradients against the port's one-process step's, at
    tests/test_torch_barlowtwins.py's size, weights and tolerances
    (GRAD_RTOL; the module docstring there says why).  One step: from
    parameters that differ within AdamW's bounds the head's BatchNorms move a
    second step's gradients past them (tests/test_torch_barlowtwins.py
    restarts its second step from one state for that reason);
  * task_mlm_itm_mpp at drop_rate 0.1 (MLM's and MPP's means over the
    global count, the ITM labels and MPP masks drawn for the global batch)
    against the port's one-process step on the 4 pairs, which
    tests/test_torch_pretrain.py holds to the JAX package;
  * the attacked irtr_attacked step (PGD image view and greedy text view),
    whose attacks take the global batch's other texts as their negatives,
    against the port's one-process step on the 4 pairs, at
    tests/test_torch_downstream.py's size, weights and batch, where
    tests/test_torch_downstream_attacked.py holds that step to the JAX
    package.

A rank's gradient reaching its own rows through the gathered head is the
sum over ranks of the global loss's gradient (W times its own): holding the
gradient of every parameter to the one-process step's catches a 1 / W there,
which AdamW's first step, dividing each gradient by its own size, would not
show in the parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import greedy_fused as JF
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from tests._torch_ddp_worker import held_across_ranks, port_cfg, run_steps, start_ranks
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_barlowtwins import (GRAD_RTOL, SENTENCES, STATS, _batch, _cfg,
                                          _trained_like)
from tests.test_torch_ddp import close_metrics
from tests.test_torch_downstream import _cfg as _downstream_cfg
from tests.test_torch_downstream import _clean, _moved
from tests.test_torch_downstream import make_batch as downstream_batch
from tests.test_torch_greedy import _write_vectors
from tests.test_torch_pretrain import ALL
from tests.test_torch_pretrain import WORDS as PRETRAIN_WORDS
from tests.test_torch_pretrain import _cfg as _pretrain_cfg
from tests.test_torch_pretrain import make_batch
from tests.test_torch_train import _close, _close_params, _jflat, _port_of
from tests._torch_threads import one_thread  # noqa: F401

PRETRAIN = ("itm", "mlm", "mpp")          # task_mlm_itm_mpp's losses
# rank 1's captions have no word the attack may change: its own live count is
# 0 from the start, rank 0's is not
STOP_RANK = ["dog runs in park", "cat sits in street", "the a on in", "the a on in"]


@pytest.fixture(scope="module")
def coupled(tmp_path_factory):
    """The JAX package's attacked BarlowTwins step on the 4 pairs, the
    port's one-process runs, and the two ranks' (BarlowTwins, then
    task_mlm_itm_mpp)."""
    d = tmp_path_factory.mktemp("ddp_bt")
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    vectors = _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)
    jtok = JTokenizer(vocab)
    jcfg = _cfg(jtok.vocab_size)
    params, state = init_vilt(jax.random.PRNGKey(0), jcfg)
    params = _trained_like(params)
    batch = _batch(jcfg, jtok, SENTENCES)
    bt = dict(cfg=port_cfg(jcfg), state_dict=_port_of(jcfg, params, state).state_dict(),
              batches=[batch], attack=(vocab, vectors), seed=0)
    stop = dict(bt, batches=[_batch(jcfg, jtok, STOP_RANK)])

    pvocab = make_tiny_vocab(str(d / "pretrain_vocab.txt"), PRETRAIN_WORDS)
    ptok = WordPieceTokenizer(pvocab)
    pcfg = _pretrain_cfg(ptok.vocab_size, losses=PRETRAIN, drop_rate=0.1)
    assert set(PRETRAIN) < set(ALL)
    pparams, pstate = init_vilt(jax.random.PRNGKey(1), pcfg)
    pre = dict(cfg=port_cfg(pcfg), state_dict=_port_of(pcfg, pparams, pstate).state_dict(),
               batches=[make_batch(pcfg, ptok, seed=s) for s in (0, 1)], seed=3)

    dcfg = _downstream_cfg(jtok.vocab_size, "irtr_attacked")
    dparams, dstate = init_vilt(jax.random.PRNGKey(0), dcfg)
    irtr = dict(cfg=port_cfg(dcfg),
                state_dict=_port_of(dcfg, _moved(dparams), dstate).state_dict(),
                batches=[_clean(downstream_batch(dcfg, jtok))], attack=(vocab, vectors), seed=5)

    runs = [bt, pre, stop, irtr]
    ranks = start_ranks({"case": "steps", "runs": runs}, d)
    one = [run_steps(r) for r in runs]

    jmodel = ViLTModel(jcfg)
    _, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), jcfg, params=params, state=state)
    jfused = JF.FusedGreedyAttack(JG.GreedyAttackBarlowTwins(jcfg, jmodel, jtok,
                                                             JG.SynonymTable(vectors, 3, 0.5)))
    tables = jfused.prep_tables(batch["text_ids"])
    jstep = JT.make_attacked_train_step(jcfg, jmodel, tx, jfused, donate=False)
    jts, jm = jstep(jts, {k: jnp.asarray(v) for k, v in dict(batch, **tables).items()},
                    jax.random.PRNGKey(7))
    return dict(cfg=jcfg, jm={k: float(v) for k, v in jm.items()},
                jwant={**_jflat(jts.params), **_jflat(jts.state)}, one=one,
                ranks=ranks.result(), pcfg=pcfg, stop_ids=stop["batches"][0]["text_ids"],
                dcfg=dcfg)


def test_two_ranks_attacked_barlowtwins_step_matches_jax(coupled):
    """One attacked task_barlowtwins step of 2 ranks x 2 pairs against the
    JAX package's on the 4 pairs: the loss within rtol 1e-5, every metric
    (num_changes among them), the six running statistics (GRAD_RTOL) and
    every parameter (_close_params) after it; the gradient of every
    parameter against the port's one-process step's (GRAD_RTOL), which
    tests/test_torch_barlowtwins.py holds to the JAX package's; the ranks
    bit-identical; the attacked ids the one-process attack's."""
    c = coupled
    r0, one = c["ranks"][0][0], c["one"][0]
    held_across_ranks([r[0] for r in c["ranks"]], one)
    np.testing.assert_allclose(r0["metrics"][0]["barlowtwins_loss"],
                               c["jm"]["barlowtwins_loss"], rtol=1e-5)
    assert r0["metrics"][0]["num_changes"] == c["jm"]["num_changes"] > 0
    close_metrics(r0["metrics"][0], c["jm"], 1e-4, "step 0")
    for path, g in r0["grads"][0].items():
        _close(f"grad {path}", g, one["grads"][0][path], GRAD_RTOL)
    ours, want = r0["leaves"][0], c["jwant"]
    for path in [p for p in want if p.endswith(STATS)]:
        _close(path, ours[path], want[path], GRAD_RTOL)
    _close_params({p: v for p, v in ours.items() if not p.endswith(STATS)},
                  {p: v for p, v in want.items() if not p.endswith(STATS)},
                  one["grads"][0], c["cfg"].learning_rate, "attacked step")


def test_two_ranks_pretraining_step_matches_one_process(coupled):
    """task_mlm_itm_mpp at drop_rate 0.1, two steps of 2 ranks x 2 pairs
    against the port's one-process steps on the 4 pairs: every metric
    (mlm_loss, mpp_loss and mlm_step_accuracy over the global count, the
    ITM losses over the global draw) within rtol 1e-5, every gradient within
    1e-5 x max(1, max|ref|), the parameters by _close_params, the ranks
    bit-identical."""
    ranks, one = [r[1] for r in coupled["ranks"]], coupled["one"][1]
    held_across_ranks(ranks, one)
    r0 = ranks[0]
    assert {"mlm_loss", "mpp_loss", "itm_loss", "itm_wpa_loss"} <= set(r0["metrics"][0])
    for it in range(2):
        close_metrics(r0["metrics"][it], one["metrics"][it], 1e-5, f"step {it}")
        for path, g in r0["grads"][it].items():
            _close(f"step {it} grad {path}", g, one["grads"][it][path])
        _close_params(r0["leaves"][it], one["leaves"][it], one["grads"][0],
                      coupled["pcfg"].learning_rate, f"step {it}")


def test_the_coupled_attack_agrees_its_exit_across_ranks(coupled):
    """The attacked task_barlowtwins step on captions of which rank 1's have
    no word to change: the fused loop's live count and commits are summed
    over the ranks, so rank 1 runs rank 0's loops, gradient passes and
    scoring forwards with it (each with its gathers; on its own count it
    would leave at once and rank 0 would wait); the ranks bit-identical, the
    ids the one-process attack's (rank 1's unchanged), the loss within rtol
    1e-5 and the metrics within 1e-4 of the one-process step's."""
    ranks, one = [r[2] for r in coupled["ranks"]], coupled["one"][2]
    held_across_ranks(ranks, one)
    r0 = ranks[0]
    assert r0["metrics"][0]["num_changes"] > 0
    np.testing.assert_array_equal(ranks[1]["ids"][0], coupled["stop_ids"][2:])
    np.testing.assert_allclose(r0["metrics"][0]["barlowtwins_loss"],
                               one["metrics"][0]["barlowtwins_loss"], rtol=1e-5)
    close_metrics(r0["metrics"][0], one["metrics"][0], 1e-4, "step 0")


def test_two_ranks_attacked_irtr_step_matches_one_process(coupled):
    """The attacked irtr_attacked step (2 PGD steps on the image, the fused
    greedy attack on the text) of 2 ranks x 2 pairs against the port's
    one-process step on the 4 pairs: both attacks read every rank's text
    projections (the InfoNCE's negatives are the global batch's other texts,
    three here and not one), so the attacked ids are the one-process
    attack's, every metric within rtol 1e-5, every gradient within 1e-5 x
    max(1, max|ref|), the parameters by _close_params, the ranks
    bit-identical."""
    ranks, one = [r[3] for r in coupled["ranks"]], coupled["one"][3]
    held_across_ranks(ranks, one)
    r0 = ranks[0]
    assert {"irtr_attacked_loss", "irtr_original_loss"} <= set(r0["metrics"][0])
    assert r0["metrics"][0]["num_changes"] > 0
    close_metrics(r0["metrics"][0], one["metrics"][0], 1e-5, "step 0")
    for path, g in r0["grads"][0].items():
        _close(f"grad {path}", g, one["grads"][0][path])
    _close_params(r0["leaves"][0], one["leaves"][0], one["grads"][0],
                  coupled["dcfg"].learning_rate, "attacked irtr step")
