"""The port's data parallelism (rmcl_tpu_torch/parallel) in two gloo processes
on the CPU: the attacked task_moco step of 2 ranks x 2 pairs against the JAX
package's make_attacked_train_step on the 4 pairs, at the size of
tests/test_torch_greedy.py (hidden 32, 2 layers, max_text_len 12, queue 16,
n_candidates 3, max_loops 2).

Each rank runs tests/_torch_ddp_worker.py under torchrun
(tests/_torch_ddp_worker.py:torchrun: torchrun ends both ranks when one
fails, its deadline kills them, and either raises with their output); the
JAX side and the port's one-process steps run in this process while the
ranks run.

Tolerances: the JAX step's, as tests/test_torch_greedy.py holds the port's
one-process attacked step: the loss within rtol 1e-5 and every metric within
rtol 1e-4 / atol 1e-5 at step one (2e-3 at step two, from parameters that
differ within AdamW's bounds, tests/test_torch_train.py), every leaf after
each step by ``_close_params``.  The gradient the optimizer took, the mean
over ranks, is held within 1e-5 x max(1, max|ref|) to the port's one-process
gradient on the 4 pairs, which tests/test_torch_greedy.py holds to the JAX
package's (compiling the JAX gradient here too would put this file over its
time); its firm elements are _close_params'.  Token ids are exact.  The
ranks' states (parameters, twins, queue, AdamW moments) are bit-identical.
At drop_rate 0.1 the port's masks are its own Philox stream
(tests/test_torch_train.py), so the two ranks are held to the port's
one-process step on the 4 pairs, which draws the same masks for each row."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import greedy_fused as JF
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import ViLTModel
from rmcl_tpu.train import step as JT
from tests._torch_ddp_worker import held_across_ranks, port_cfg, run_steps, start_ranks
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_greedy import SENTENCES, _batch, _step_cfg, _write_vectors
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests._torch_threads import one_thread  # noqa: F401

def close_metrics(ours, ref, rtol, what):
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], float(want), rtol=rtol, atol=1e-5,
                                   err_msg=f"{what} {key}")


# ------------------------------------------------------ the attacked step
@pytest.fixture(scope="module")
def moco(tmp_path_factory):
    """The 4-pair batch of tests/test_attacks.py, the weights (twins apart
    from the query side), two steps of the JAX package's attacked step, the
    port's one-process steps, and the two ranks' (drop_rate 0, and 0.1
    against the port alone)."""
    d = tmp_path_factory.mktemp("ddp")
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    vectors = _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)
    jtok = JTokenizer(vocab)
    jcfg = _step_cfg(jtok.vocab_size)
    params, state = ViLTModel(jcfg).init(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    batch = _batch(jcfg, jtok, SENTENCES["four"])
    sd = _port_of(jcfg, params, state).state_dict()
    runs = [dict(cfg=port_cfg(jcfg, drop_rate=p), state_dict=sd, batches=[batch, batch],
                 attack=(vocab, vectors), seed=0) for p in (0.0, 0.1)]
    # one launch a run, both at once; the one-process runs on a thread while
    # the JAX step compiles
    launches = [start_ranks({"case": "steps", "runs": [r]}, d) for r in runs]
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    one = pool.submit(lambda: [run_steps(r) for r in runs])
    pool.shutdown(wait=False)

    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), jcfg, params=params,
                                            state=state)
    jfused = JF.FusedGreedyAttack(JG.GreedyAttackMoco(jcfg, jmodel, jtok,
                                                      JG.SynonymTable(vectors, 3, 0.5)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tables = {k: jnp.asarray(v) for k, v in jfused.prep_tables(batch["text_ids"]).items()}
    jstep = JT.make_attacked_train_step(jcfg, jmodel, tx, jfused, donate=False)
    jsteps = []
    for it in range(2):
        jts, jm = jstep(jts, dict(jbatch, **tables), jax.random.PRNGKey(7 + it))
        jsteps.append(({k: float(v) for k, v in jm.items()},
                       {**_jflat(jts.params), **_jflat(jts.state)}))
    per_launch = [f.result() for f in launches]          # [run][rank][0]
    ranks = [[res[rank][0] for res in per_launch] for rank in range(2)]
    return dict(cfg=jcfg, jsteps=jsteps, one=one.result(), ranks=ranks)


def test_two_ranks_attacked_moco_step_matches_jax(moco):
    """Two attacked task_moco steps of 2 ranks x 2 pairs against the JAX
    package's one-program step on the 4 pairs: the metrics (num_changes and
    change_rate among them), every leaf after each step (parameters, twins,
    the queue and its pointer: the enqueue writes the keys of both ranks);
    the gradients of both steps against the port's one-process step's, the
    ranks bit-identical, the attacked ids the one-process attack's."""
    c = moco
    r0, one = c["ranks"][0][0], c["one"][0]
    held_across_ranks([r[0] for r in c["ranks"]], one)
    assert r0["metrics"][0]["num_changes"] == c["jsteps"][0][0]["num_changes"] > 0
    np.testing.assert_allclose(r0["metrics"][0]["moco_loss"], c["jsteps"][0][0]["moco_loss"],
                               rtol=1e-5)
    for it in range(2):
        for path, g in r0["grads"][it].items():
            _close(f"step {it} grad {path}", g, one["grads"][it][path])
    firm = {p: g for p, g in one["grads"][0].items() if not p.startswith("k_")}
    for it, (jm, want) in enumerate(c["jsteps"]):
        close_metrics(r0["metrics"][it], jm, 1e-4 if it == 0 else 2e-3, f"step {it}")
        _close_params(r0["leaves"][it], want, firm, c["cfg"].learning_rate, f"step {it}")
    assert int(r0["leaves"][1]["proj_queue_ptr"]) == 8


def test_two_ranks_draw_the_one_process_masks(moco):
    """drop_rate 0.1: two attacked steps of 2 ranks x 2 pairs against the
    port's one-process step on the 4 pairs, which draws the dropout seeds of
    the global batch from the same generator: the loss within rtol 1e-5 and
    the metrics within 1e-4, the gradients within 1e-5 x max(1, max|ref|),
    the leaves by _close_params, the ranks bit-identical, the ids exact."""
    ranks, one = [r[1] for r in moco["ranks"]], moco["one"][1]
    held_across_ranks(ranks, one)
    r0 = ranks[0]
    for it in range(2):
        np.testing.assert_allclose(r0["metrics"][it]["moco_loss"], one["metrics"][it]["moco_loss"],
                                   rtol=1e-5)
        close_metrics(r0["metrics"][it], one["metrics"][it], 1e-4, f"step {it}")
        for path, g in r0["grads"][it].items():
            _close(f"step {it} grad {path}", g, one["grads"][it][path])
        _close_params(r0["leaves"][it], one["leaves"][it],
                      {p: g for p, g in one["grads"][0].items() if not p.startswith("k_")},
                      moco["cfg"].learning_rate, f"step {it}")
    # dropout was on: the masked step differs from the unmasked one
    assert r0["metrics"][0]["moco_loss"] != moco["ranks"][0][0]["metrics"][0]["moco_loss"]
