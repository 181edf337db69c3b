"""The port's attacked downstream tasks (vqa_attacked, nlvr2_attacked,
irtr_attacked: objectives/downstream.py with their PGD, the greedy attackers
GreedyAttackVqa / Nlvr2 / Irtr host and fused, train/loop.py's extras, the
clean and attacked steps of train/step.py) against the JAX package on the CPU
in fp32, at tests/test_torch_downstream.py's sizes, batch, weights and
tolerances (its module docstring), whose helpers these tests share.  Apart
from that file so that the two run on separate workers."""

import numpy as np
import pytest
import torch

from rmcl_tpu.attacks import greedy_fused as JF
from rmcl_tpu_torch.attacks import greedy as TG
from rmcl_tpu_torch.attacks import greedy_fused as TF
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.train import loop as TL
from rmcl_tpu_torch.train import step as TT
from tests.test_torch_downstream import (ATTACKED, JG_ATTACKERS, RTOL, B, _check_step, _clean,
                                         _jax_step, _port, _t, files, j,  # noqa: F401
                                         objective_matches_jax, train_step_matches_jax)
from tests.test_torch_train import _close
from tests._torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("task", ATTACKED)
def test_attacked_objective_matches_jax(j, task):
    """The attacked tasks' compute_* with 2-step PGD and the swapped captions
    against the JAX package's (``objective_matches_jax``)."""
    objective_matches_jax(j, task)


@pytest.mark.parametrize("task", ATTACKED)
def test_attacked_task_train_step_matches_jax(j, task):
    """make_train_step of the attacked tasks, the text view from the batch
    (``train_step_matches_jax``)."""
    train_step_matches_jax(j, task)


# --------------------------------------------------------------- greedy
def _port_extras(s):
    return tuple(torch.from_numpy(np.array(e)) if hasattr(e, "shape") else e
                 for e in s.extras)


def _same(ours, ref, what):
    np.testing.assert_array_equal(ours["txt_input_ids"], ref["txt_input_ids"], err_msg=what)
    np.testing.assert_array_equal(ours["text_masks"], ref["text_masks"], err_msg=what)
    assert ours["changes_verification"] == ref["changes_verification"], what
    assert abs(ours["change_rate"] - ref["change_rate"]) < 1e-9, what


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("task", ATTACKED)
def test_greedy_attack_matches_jax(j, task, fused):
    """The framework's greedy attack, host and fused, with compaction on
    (greedy_compact_frac 0.5) and the scoring chunked (greedy_score_max_rows
    4), against the JAX package's host attack on the same weights and extras
    (attacks/greedy.py:greedy_attack_extras, held against the JAX package's):
    token ids, masks and change counts equal, some word changed; the fused
    attack launches no kernel on the CPU, reads the host once per loop plus
    once, and compacts the live rows once they fit in half the batch."""
    s = j(task)
    cfg = s.cfg.replace(greedy_score_max_rows=4)
    ts = _port(s)
    vocab, vectors = j.files
    base = TG.GREEDY_ATTACKERS[task](cfg, ts.model, WordPieceTokenizer(vocab),
                                     TG.SynonymTable(vectors, 3, 0.5))
    assert base.per_sample_independent and base.score_chunk(B, 3) == 1
    clean = _t(_clean(s.batch))
    extras = TL.make_greedy_extras_fn(cfg, ts.model)(ts, clean)
    for e, r in zip(extras, _port_extras(s)):
        if isinstance(e, torch.Tensor):
            _close("extras", e, r, RTOL)
        else:
            assert e == r
    att = TF.FusedGreedyAttack(base) if fused else base
    if fused:
        att.record = []
    FB.reset_launches()
    ours = att.adv_attack_samples(clean, extras)
    assert FB.launches == dict.fromkeys(FB.launches, 0)
    _same(ours, s.attacked, f"{task} {'fused' if fused else 'host'}")
    assert sum(s.attacked["changes_verification"]) > 0
    if fused:
        st = att.last_stats
        assert st["host_reads"] == st["loops"] + 1
        rows = [len(r["rows"]) for r in att.record]
        assert rows[0] == B and (len(rows) == 1 or min(rows) < B), rows



@pytest.mark.parametrize("task", ATTACKED)
def test_attacked_train_step_matches_jax(j, task):
    """make_attacked_train_step with the framework's fused greedy attack
    (compaction on) against the JAX package's step on the ids of its host
    attack (the ids its one-program attacked step hands over): the tables
    equal the JAX package's, num_changes and change_rate the attack's, every
    other metric and every parameter after AdamW as
    test_train_step_matches_jax holds them."""
    s = j(task)
    clean = _clean(s.batch)
    want, jm, grads = _jax_step(s, dict(clean, attacked_text_ids=s.attacked["txt_input_ids"],
                                        attacked_text_masks=s.attacked["text_masks"]))
    vocab, vectors = j.files
    ts = _port(s)
    fused = TF.FusedGreedyAttack(TG.GREEDY_ATTACKERS[task](
        s.cfg, ts.model, WordPieceTokenizer(vocab), TG.SynonymTable(vectors, 3, 0.5)))
    tables = fused.prep_tables(clean["text_ids"])
    jtables = JF.FusedGreedyAttack(JG_ATTACKERS[task](s.cfg, s.model, j.tok, j.syn)
                                   ).prep_tables(clean["text_ids"])
    for key, v in tables.items():
        np.testing.assert_array_equal(v, jtables[key], err_msg=key)
    step = TT.make_attacked_train_step(s.cfg, ts, fused)
    metrics = step(dict(_t(clean), **tables), torch.Generator().manual_seed(0))
    assert metrics.pop("num_changes").item() == s.attacked["num_changes"] > 0
    np.testing.assert_allclose(metrics.pop("change_rate").item(), s.attacked["change_rate"],
                               rtol=1e-6)
    _check_step(s.cfg, ts, metrics, want, jm, grads, f"attacked {task}")
