"""The port's attacked task_moco step over two gloo processes at accum 2, with
the replicated optimizer and with ZeRO-1 (``cfg.zero1``: the optimizer's state
sharded by ``torch.distributed.optim.ZeroRedundancyOptimizer``), against the
JAX package's make_train_step(accum=2) (optax MultiSteps) on the same 4-pair
micro-batches with the attack's ids in them, at tests/test_torch_ddp.py's
size and tolerances.  The attack inside the step is held there to the JAX
package's one-program step (make_attacked_train_step), and here its ids to
the port's one-process attack; compiling the one-program step at accum 2
too would put this file over its time.

One optimizer cycle of two micro-steps: each rank accumulates its own
micro-gradients (the running mean of train/step.py), and the mean over ranks
is taken once, at the cycle's end, before the optimizer.  ZeRO-1 is held to
the replicated optimizer bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import ViLTModel
from rmcl_tpu.train import step as JT
from tests._torch_ddp_worker import held_across_ranks, port_cfg, run_steps, start_ranks
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_ddp import close_metrics
from tests.test_torch_greedy import SENTENCES, _batch, _step_cfg, _write_vectors
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests._torch_threads import one_thread  # noqa: F401

# the micro-batches: tests/test_attacks.py's four captions on two sets of
# images (the same captions keep the JAX package's attack tables, and with
# them its program, the same shape: one compile)
IMAGE_SEEDS = (0, 1)


@pytest.fixture(scope="module")
def accum(tmp_path_factory):
    """Two micro-steps (one optimizer step) of the JAX package's step at
    accum 2 on the one-process attack's ids, the port's attacked step in one
    process, and two ranks' with zero1 off and on."""
    d = tmp_path_factory.mktemp("ddp_accum")
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    vectors = _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)
    jtok = JTokenizer(vocab)
    jcfg = _step_cfg(jtok.vocab_size)
    params, state = ViLTModel(jcfg).init(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    batches = [_batch(jcfg, jtok, SENTENCES["four"], seed=s) for s in IMAGE_SEEDS]
    sd = _port_of(jcfg, params, state).state_dict()
    runs = [dict(cfg=port_cfg(jcfg, zero1=z), state_dict=sd, batches=batches, accum=2,
                 attack=(vocab, vectors), seed=0) for z in (False, True)]
    ranks = start_ranks({"case": "steps", "runs": runs}, d)
    one = run_steps(runs[0])

    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), jcfg, params=params,
                                            state=state, accum=2)
    jstep = JT.make_train_step(jcfg, jmodel, tx, donate=False, accum=2)
    jsteps = []
    for it, b in enumerate(batches):
        b = dict(b, attacked_text_ids=one["ids"][it], attacked_text_masks=one["masks"][it])
        jts, jm = jstep(jts, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(7 + it))
        jsteps.append(({k: float(v) for k, v in jm.items()},
                       {**_jflat(jts.params), **_jflat(jts.state)}))
    return dict(cfg=jcfg, jsteps=jsteps, one=one, ranks=ranks.result())


def test_two_ranks_at_accum_two_match_jax(accum):
    """Both micro-steps of 2 ranks x 2 pairs: the metrics and every leaf
    (mid-cycle the parameters stay, the twins and the queue move) against the
    JAX package's accum-2 step; the cycle's gradient (the mean over ranks of
    each rank's running mean) against the port's one-process accum-2 step's;
    the ranks bit-identical; the attacked ids the one-process attack's."""
    c = accum
    r0, one = c["ranks"][0][0], c["one"]
    held_across_ranks([r[0] for r in c["ranks"]], one)
    for path, g in r0["grads"][1].items():
        _close(f"cycle grad {path}", g, one["grads"][1][path])
    firm = {p: g for p, g in one["grads"][1].items() if not p.startswith("k_")}
    for it, (jm, want) in enumerate(c["jsteps"]):
        ours = dict(r0["metrics"][it])
        for key in ("num_changes", "change_rate"):     # the attack's, not the JAX step's
            assert ours.pop(key) == one["metrics"][it][key]
        close_metrics(ours, jm, 1e-4, f"micro-step {it}")
        _close_params(r0["leaves"][it], want, firm, c["cfg"].learning_rate,
                      f"micro-step {it}")
    assert int(r0["leaves"][1]["proj_queue_ptr"]) == 8


def test_zero1_is_the_replicated_optimizer_bit_for_bit(accum):
    """zero1=True over the two ranks: every leaf and metric of both
    micro-steps equal to zero1=False's bit for bit, the ranks' models
    bit-identical."""
    plain, zero = accum["ranks"][0][0], accum["ranks"][0][1]
    held_across_ranks([r[1] for r in accum["ranks"]], accum["one"])
    assert zero["metrics"] == plain["metrics"]
    for it in range(2):
        assert set(zero["leaves"][it]) == set(plain["leaves"][it])
        for path, v in plain["leaves"][it].items():
            np.testing.assert_array_equal(zero["leaves"][it][path], v, err_msg=path)
