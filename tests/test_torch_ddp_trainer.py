"""The port's multi-process paths outside the step, in two gloo processes on
the CPU (tests/_torch_ddp_worker.py under torchrun, whose own cleanup a
failing rank and whose deadline a hung rank meets here): comm's
object collectives and dist's tensor ones; the eval gathers, mirroring
tests/test_multiprocess.py's eval test (the VQA submission merged on rank 0,
the recall's image rows sharded over the ranks, the metric bags summed over
them), each against the same call in one process; the preemption consensus,
mirroring its preemption test; and ``cli.run with task_moco ... device=cpu``
as two ranks of torchrun.  The tables and vocabulary are
tests/test_multiprocess.py's (_make_eval_data), the model its workers' (C =
32, 1 layer, fp32)."""

import concurrent.futures
import os
import time

import numpy as np
import pytest
import torch

from rmcl_tpu_torch.core.config import build_config
from tests._torch_ddp_worker import (REPO, WAIT_S, WorkerFailure, run_eval, run_ranks,
                                     start_ranks, torchrun)
from tests.test_multiprocess import _make_eval_data
from tests._torch_threads import one_thread  # noqa: F401

TINY = dict(hidden_size=32, num_heads=2, num_layers=1, patch_size=16, image_size=32,
            image_bucket_hw=(32, 48), max_text_len=12, vocab_size=64,
            compute_dtype="float32", drop_rate=0.0, warmup_steps=0, num_workers=2,
            max_image_len=-1)


# ------------------------------------------------ comm, a failing rank
# the deadline of the run whose rank 1 hangs: torchrun has started both
# ranks well before it, even under load
HANG_S = 10


@pytest.fixture(scope="module")
def short_runs(tmp_path_factory):
    """The comm ranks' run and the runs with a rank that raises and one that
    hangs, all three started at once: {case: (result or WorkerFailure,
    seconds)}."""
    d = tmp_path_factory.mktemp("ddp_short")

    def timed(case, timeout):
        t0 = time.monotonic()
        try:
            out = run_ranks({"case": case}, d, timeout=timeout)
        except WorkerFailure as e:
            out = e
        return out, time.monotonic() - t0

    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        futs = {case: pool.submit(timed, case, t)
                for case, t in (("comm", WAIT_S), ("raise", 30), ("hang", HANG_S))}
        return {case: f.result() for case, f in futs.items()}


def test_comm_and_tensor_collectives(short_runs):
    """all_gather of objects of unequal size in rank order, gather to rank 1
    only, reduce_dict's mean and sum and reduce_over_ranks' in each value's
    dtype, shared_random_seed (rank 0's draw on every rank), gather_rows in
    rank order with the own rows of the gradient times W, local_rows,
    batch_mean's parts whose rank mean is the global sum over the global
    count."""
    r, _ = short_runs["comm"]
    assert not isinstance(r, WorkerFailure), r
    mine = [{"rank": i, "payload": "x" * (10 + 1000 * i)} for i in range(2)]
    for i, res in enumerate(r):
        assert res["world"] == 2
        assert res["all_gather"] == mine
        assert res["gather"] == (mine if i == 1 else [])
        assert res["reduce_mean"] == {"a": 1.5, "b": 1.0}
        assert res["reduce_sum"] == {"a": 3.0}
        mean, total = res["reduce_tensors"]
        assert mean["a"].dtype == torch.float32 and mean["b"].dtype == torch.float64
        assert (mean["a"].item(), mean["b"].item(), total["a"].item()) == (1.5, 1.0, 3.0)
        assert res["seed_again"] == res["rank0_draw"]
        want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * k for k in range(2)])
        assert torch.equal(res["gathered"], want)
        g = torch.arange(1.0, 13).reshape(6, 2)[3 * i:3 * i + 3] * 2
        assert torch.equal(res["gather_grad"], g)
        assert torch.equal(res["local_rows"], torch.arange(8.0).reshape(4, 2)[2 * i:2 * i + 2])
    assert r[0]["seed"] == r[1]["seed"]
    assert (r[0]["batch_mean"] + r[1]["batch_mean"]).item() / 2 == pytest.approx(7 / 5)


def _gone(pid: int) -> bool:
    """No process ``pid``, or only its zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


@pytest.mark.parametrize("case", ["raise", "hang"])
def test_a_failing_or_hung_rank_fails_the_run(short_runs, case):
    """A rank that raises (the other waiting in a barrier) fails the run at
    once, torchrun ending the other; a rank that hangs (the other waiting in
    a barrier) fails it at the deadline, which kills torchrun's agent and
    both ranks; the error carries the ranks' output."""
    err, took = short_runs[case]
    assert isinstance(err, WorkerFailure), err
    if case == "raise":
        assert "torchrun exited with 1" in str(err)
        assert "fails on purpose" in err.output
        assert took < 25
    else:
        assert f"did not finish within {HANG_S}" in str(err) and took < HANG_S + 10
        assert len(err.pids) >= 3, err.pids          # torchrun's agent and both ranks
        assert all(_gone(p) for p in err.pids), err.pids


# ------------------------------------------------------- the Trainer's paths
def _eval_spec(datadir, out):
    """The eval and preemption configurations of tests/_mp_eval_worker.py and
    tests/_mp_preempt_worker.py, the port's, writing under ``out``."""
    vocab = os.path.join(datadir, "vocab.txt")
    vqa = build_config("task_finetune_vqa", datasets=("vqa",),
                       data_root=os.path.join(datadir, "vqa"), test_only=True,
                       vqav2_label_size=5, max_steps=2, batch_size=8,
                       log_dir=os.path.join(out, "vqa"), **TINY)
    irtr = build_config("task_finetune_irtr_coco", datasets=("coco",),
                        data_root=os.path.join(datadir, "coco"), max_steps=2, batch_size=8,
                        draw_false_text=2, log_dir=os.path.join(out, "irtr"), **TINY)
    # global batch 2: one pair per rank and step, 4 micro-steps per epoch on a
    # rank's half of the 8 VQA rows; the consensus every 2 micro-steps; ZeRO-1,
    # so that the save consolidates the optimizer's shards and the restore
    # loads them back on every rank
    preempt = build_config("task_finetune_vqa", datasets=("vqa",),
                           data_root=os.path.join(datadir, "vqa"), vqav2_label_size=5,
                           max_steps=6, batch_size=2, preempt_sync_every=2, zero1=True,
                           log_dir=os.path.join(out, "preempt"), **TINY)
    return {"case": "trainer", "vocab": vocab, "vqa_cfg": vqa, "irtr_cfg": irtr,
            "preempt": {"cfg": preempt, "vocab": vocab}}


CLI_ARGS = ["with", "task_finetune_irtr_coco", "datasets=('coco',)", "fast_dev_run=True",
            "hidden_size=32", "num_heads=2", "num_layers=1", "patch_size=16", "image_size=32",
            "image_bucket_hw=(32,48)", "max_text_len=12", "vocab_size=64",
            "compute_dtype=float32", "drop_rate=0.0", "max_image_len=-1", "draw_false_text=2",
            "batch_size=4", "num_workers=2", "get_recall_metric=False", "device=cpu"]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The two ranks' eval and preemption runs and their cli.run, all
    started at once; the one-process eval meanwhile."""
    d = tmp_path_factory.mktemp("ddp_trainer")
    datadir = str(d / "data")
    os.makedirs(datadir)
    _make_eval_data(datadir)
    ranks = start_ranks(_eval_spec(datadir, str(d / "ranks")), d)
    cli = ["-m", "rmcl_tpu_torch.cli.run", *CLI_ARGS,
           f"data_root={os.path.join(datadir, 'coco')}",
           f"tokenizer={os.path.join(datadir, 'vocab.txt')}", f"log_dir={d / 'cli'}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        cli_out = pool.submit(torchrun, cli, 2, WAIT_S, env=env, cwd=REPO)
        one = run_eval(_eval_spec(datadir, str(d / "one")))
        return dict(ranks=ranks.result(), one=one, cli=cli_out.result(), cli_dir=d / "cli")


def test_eval_gathers_match_one_process(trainer_runs):
    """Trainer.validate("test") of task_finetune_vqa on 2 ranks: rank 0 alone
    writes the merged submission, every question id exactly once, byte for
    byte the one-process file; both ranks' metrics (the bags summed over the
    ranks) the one-process bag's; the recall of the IR/TR task with its
    image rows sharded over the ranks equal on both ranks to the unsharded
    recall and to the one-process recall."""
    import json
    r0, r1 = (r["eval"] for r in trainer_runs["ranks"])
    one = trainer_runs["one"]
    assert r1["submission"] is None
    assert r0["submission"] == one["submission"]
    assert sorted(d["question_id"] for d in json.loads(r0["submission"])) == list(range(100, 108))
    for r in (r0, r1):
        assert set(r["vqa_metrics"]) == set(one["vqa_metrics"])
        for k, v in one["vqa_metrics"].items():
            np.testing.assert_allclose(r["vqa_metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert r["recall_sharded"] == r["recall_local"] == one["recall_local"]
    assert "vqa_score" in r0["vqa_metrics"]


def test_preemption_consensus_stops_every_rank_at_one_step(trainer_runs):
    """Rank 1 alone asks for preemption after its first micro-step; with
    preempt_sync_every 2 the flag reaches rank 0 at micro-step 2: both ranks
    stop there (mid-epoch, short of max_steps 6), 'last' exists, and its
    restore (ZeRO-1: the optimizer's shards consolidated on rank 0 for the
    save, each rank's loaded back) gives step 2 and the same state on both
    ranks."""
    p0, p1 = (r["preempt"] for r in trainer_runs["ranks"])
    for p in (p0, p1):
        assert p["steps_done"] == 2 and p["has_last"] and p["restored_step"] == 2
    assert p0["hash"] == p1["hash"]


def test_cli_trains_on_two_ranks(trainer_runs):
    """``torchrun --nproc_per_node=2 -m rmcl_tpu_torch.cli.run with ...
    device=cpu``: both ranks join a gloo group and train; one rank alone
    (rank 0) prints the banner and the metrics and writes the checkpoint
    and the metrics file."""
    out = trainer_runs["cli"]
    assert out.count("ranks=2") == 1 and out.count("\nval/the_metric: ") == 1, out
    workdir = trainer_runs["cli_dir"] / "finetune_irtr_coco"
    assert (workdir / "LAST.ptr").is_file() and (workdir / "metrics.jsonl").is_file()
