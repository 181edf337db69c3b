"""One rank of the port's two-process tests (tests/test_torch_ddp*.py), and
the tests' side of it (``torchrun``, ``run_ranks``, ``start_ranks``).

The ranks run under torchrun, the launcher the port documents:
``torchrun --standalone --nproc_per_node=2 tests/_torch_ddp_worker.py SPEC
OUT``.  SPEC is a ``torch.save``d dict whose ``case`` names what to run; the
rank joins a gloo group on the CPU (and, when SPEC has a ``grid``, the
``(data, model)`` grid of ``parallel/mesh.py:init_grid``), runs it and saves
its result as ``OUT/rank<r>.pt``.  This module imports torch and the port only; the tests
hold the results to the JAX package and to the same functions run in one
process (``run_steps``, ``run_eval``, called without a process group).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo

from rmcl_tpu_torch.compat.from_jax import leaves_to_jax  # noqa: E402
from rmcl_tpu_torch.parallel import comm, dist, mesh  # noqa: E402
from rmcl_tpu_torch.parallel.sharding_rules import gather_model, shard_dim  # noqa: E402

COLLECTIVE_TIMEOUT_S = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 100          # each spawn's deadline: the ranks take ~5-15 s


# ------------------------------------------------------ the tests' side
class WorkerFailure(RuntimeError):
    """torchrun failed or its deadline passed; ``output`` holds its output
    and its ranks', ``pids`` the processes the deadline killed."""

    def __init__(self, msg: str, output: str, pids=()):
        super().__init__(f"{msg}\n{output[-8000:]}")
        self.output, self.pids = output, list(pids)


def _descendants(pid: int) -> list:
    """The live descendants of ``pid``, from every process's parent in
    /proc/<pid>/stat."""
    parent = {}
    for name in os.listdir("/proc"):
        try:
            with open(f"/proc/{name}/stat") as f:
                parent[int(name)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (ValueError, OSError, IndexError):
            continue
    out, todo = [], [pid]
    while todo:
        kids = [q for q, pp in parent.items() if pp == todo[0]]
        out += kids
        todo = todo[1:] + kids
    return out


def _kill_tree(pid: int) -> list:
    """SIGKILL torchrun's agent ``pid`` and every descendant, each rank's
    process group included (torchrun starts each rank in a session of its
    own); the agent is stopped first, so that it starts no rank meanwhile.
    Returns the pids killed."""
    os.kill(pid, signal.SIGSTOP)
    pids = [pid] + _descendants(pid)
    for q in reversed(pids):
        for kill in (os.killpg, os.kill):
            try:
                kill(q, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    return pids


def torchrun(argv, nprocs: int, timeout: float, env=None, cwd=None) -> str:
    """``torchrun --standalone --nproc_per_node=nprocs *argv`` (a script and
    its arguments, or ``-m module ...``): its output and its ranks', once it
    exits with 0.  torchrun ends every rank when one fails and exits with
    non-zero; at ``timeout`` seconds its agent and every rank are killed.
    Either raises ``WorkerFailure``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nprocs}", "--max-restarts=0", *argv]
    pids = ()
    with tempfile.TemporaryFile(mode="w+b") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL, env=env, cwd=cwd,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout)
            failed = f"torchrun exited with {rc}" if rc else None
        except subprocess.TimeoutExpired:
            pids = _kill_tree(proc.pid)
            proc.wait()
            failed = f"the ranks did not finish within {timeout} s"
        f.seek(0)
        output = f.read().decode(errors="replace")
    if failed:
        raise WorkerFailure(failed, output, pids)
    return output


def port_cfg(jcfg, **kw):
    """The port's config with the JAX config's fields (the ranks import no
    JAX, so they cannot unpickle its config)."""
    from rmcl_tpu_torch.core.config import RMCLConfig
    return RMCLConfig(**dataclasses.asdict(jcfg)).replace(**kw)


def run_ranks(spec, tmp_path, world=2, timeout=WAIT_S):
    """``spec`` in ``world`` gloo ranks of this script; their results."""
    d = tmp_path / f"ranks-{spec['case']}-{time.monotonic_ns()}"
    d.mkdir()
    torch.save(spec, d / "spec.pt")
    torchrun([os.path.abspath(__file__), str(d / "spec.pt"), str(d)], world, timeout,
             env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=REPO)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


def start_ranks(spec, tmp_path, **kw):
    """``run_ranks`` on a thread: the ranks run while the test works."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run_ranks, spec, tmp_path, **kw)
    pool.shutdown(wait=False)
    return fut


def held_across_ranks(ranks, one):
    """Two ranks' runs of run_steps against one process's: the ranks'
    states bit-identical at every step, their metrics equal to each other,
    and their attacked ids, rank order, the one-process run's."""
    r0, r1 = ranks
    assert r0["hash"] == r1["hash"]
    assert r0["metrics"] == r1["metrics"]
    for a, b, ref in zip(r0["ids"], r1["ids"], one["ids"]):
        np.testing.assert_array_equal(np.concatenate([a, b]), ref)


# ------------------------------------------------------------- a rank


def state_hash(ts, replicated: bool = False) -> str:
    """sha256 of every tensor of the model's state dict (parameters, twins,
    queue, BatchNorm statistics) and of the optimizer's state (its moments;
    ZeRO-1 shards them, and then only the model's); with ``replicated``, of
    the entries a model axis does not shard alone."""
    h = hashlib.sha256()
    keep = (lambda name: shard_dim(name) is None) if replicated else (lambda name: True)
    tensors = sorted((k, v) for k, v in ts.model.state_dict().items() if keep(k))
    if not hasattr(ts.optimizer, "consolidate_state_dict"):
        names = {id(p): n for n, p in ts.model.named_parameters()}
        order = [names[id(p)] for g in ts.optimizer.param_groups for p in g["params"]]
        for i, st in sorted(ts.optimizer.state_dict()["state"].items()):
            if keep(order[i]):
                tensors += [(f"opt.{order[i]}.{k}", v) for k, v in sorted(st.items())
                            if isinstance(v, torch.Tensor)]
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def full_leaves(ts, cfg, grads: bool = False):
    """``leaves_to_jax`` of the full model: on a grid with a model axis the
    model group's shards gathered into an unsharded ``ViLT``
    (``sharding_rules.gather_model``)."""
    if mesh.model_size() == 1:
        return leaves_to_jax(ts.model, grads=grads)
    return leaves_to_jax(gather_model(cfg, ts.model, grads), grads=grads)


class mlp_masks:
    """Records the in-MLP keep masks (draw 0 at the MLP's hidden width) that
    the plain training ops and the dropout op (configuration F's plain MLP)
    draw, in call order, as numpy arrays."""

    def __init__(self, hidden: int):
        from rmcl_tpu_torch.ops import dropout as DO
        from rmcl_tpu_torch.ops import fused_block_train as FT
        self.modules, self.hidden, self.seen = (FT, DO), hidden, []

    def __enter__(self):
        inner = self.inner = self.modules[0].keep_mask

        def keep_mask(seeds, draw, rows, cols, p, col0=0):
            out = inner(seeds, draw, rows, cols, p, col0)
            if draw == 0 and cols != self.hidden:
                self.seen.append(out.numpy().copy())
            return out
        for mod in self.modules:
            mod.keep_mask = keep_mask
        return self

    def __exit__(self, *exc):
        for mod in self.modules:
            mod.keep_mask = self.inner


def run_steps(run: dict) -> dict:
    """``run["batches"]``, global batches (numpy), through the training step
    of ``run["cfg"]`` from ``run["state_dict"]``, this rank's rows of each
    (all of them in one process): the attacked step with the fused attacker
    of ``run["attack"]`` = (vocabulary, vectors) when given, else
    ``make_train_step``; ``run["accum"]`` micro-steps per optimizer step; the
    generator seeded with ``run["seed"]``.  Per step: the metrics, every leaf
    (``leaves_to_jax``), the gradients (after an optimizer step: the mean
    over ranks the optimizer took), the state's hash and this rank's attacked
    ids and masks."""
    from rmcl_tpu_torch.attacks import greedy as TG
    from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
    from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
    from rmcl_tpu_torch.models.vilt import ViLT
    from rmcl_tpu_torch.train import step as TT
    cfg = run["cfg"]
    model = ViLT(cfg)
    model.load_state_dict(run["state_dict"])
    ts = TT.create_train_state(cfg, model=model, device="cpu", accum=run.get("accum", 1))
    ids = []
    if run.get("attack"):
        vocab, vectors = run["attack"]
        framework = TG.greedy_attack_framework(cfg)
        fused = FusedGreedyAttack(TG.GREEDY_ATTACKERS[framework](
            cfg, ts.model, WordPieceTokenizer(vocab), TG.SynonymTable(vectors, 3, 0.5)))
        body = fused._attack

        def keep(*a, **kw):
            out = body(*a, **kw)
            ids.append((out[0].clone(), out[1].clone()))
            return out
        fused._attack = keep
        step = TT.make_attacked_train_step(cfg, ts, fused)
    else:
        step = TT.make_train_step(cfg, ts)
    gen = torch.Generator().manual_seed(run.get("seed", 0))
    out = {k: [] for k in ("metrics", "leaves", "grads", "hash", "replicated")}
    recorder = mlp_masks(cfg.hidden_size)
    for gb in run["batches"]:
        b = {k: dist.local_rows(torch.from_numpy(np.ascontiguousarray(v))).contiguous()
             for k, v in gb.items()}
        if run.get("attack"):
            b.update(fused.prep_tables(b["text_ids"].numpy()))
        with recorder:
            metrics = step(b, gen)
        out["metrics"].append({k: v.item() for k, v in metrics.items()})
        out["leaves"].append(full_leaves(ts, cfg))
        out["grads"].append(full_leaves(ts, cfg, grads=True))
        out["hash"].append(state_hash(ts))
        out["replicated"].append(state_hash(ts, replicated=True))
    out["ids"] = [i.numpy() for i, _ in ids]
    out["masks"] = [m.numpy() for _, m in ids]
    out["mlp_masks"] = recorder.seen
    out["grid"] = (mesh.data_rank(), mesh.model_rank())
    return out


def _eval_trainer(cfg, vocab):
    from rmcl_tpu_torch.train.loop import Trainer
    tr = Trainer(cfg, workdir=cfg.log_dir, vocab_path=vocab, device="cpu")
    tr.setup()
    return tr


def run_eval(spec: dict) -> dict:
    """The eval paths: ``Trainer.validate("test")`` of a VQA config (its
    metrics and, on rank 0, the submission file's bytes) and the recall of
    an IRTR config, sharded over the ranks and not."""
    from rmcl_tpu_torch.eval.retrieval import compute_irtr_recall
    out = {}
    tr = _eval_trainer(spec["vqa_cfg"], spec["vocab"])
    out["vqa_metrics"] = tr.validate(split="test")
    path = os.path.join(spec["vqa_cfg"].log_dir,
                        f"vqa_submit_{spec['vqa_cfg'].exp_name}.json")
    out["submission"] = (open(path, "rb").read()
                         if comm.is_main_process() and os.path.exists(path) else None)
    tri = _eval_trainer(spec["irtr_cfg"], spec["vocab"])
    out["recall_sharded"] = compute_irtr_recall(tri, split="test", txt_chunk=4, verbose=False)
    out["recall_local"] = compute_irtr_recall(tri, split="test", txt_chunk=4, verbose=False,
                                              shard_by_process=False)
    return out


def run_preempt(spec: dict) -> dict:
    """Rank 1 alone asks for preemption after its first micro-step; every
    rank's Trainer.fit must stop at the same consensus step."""
    tr = _eval_trainer(spec["cfg"], spec["vocab"])
    if comm.get_rank() == 1:
        inner = tr.step_fn

        def step_and_flag(batch, gen):
            metrics = inner(batch, gen)
            tr.request_preemption()
            return metrics
        tr.step_fn = step_and_flag
    tr.fit()
    restored = tr.ckpt.restore(tr.ts, "last")
    return {"steps_done": tr.steps_done, "has_last": tr.ckpt.has("last"),
            "restored_step": restored.step, "hash": state_hash(restored)}


def run_comm(_spec: dict) -> dict:
    """comm's object collectives and dist's tensor ones, on values that
    differ by rank."""
    rank, world = comm.get_rank(), comm.get_world_size()
    mine = {"rank": rank, "payload": "x" * (10 + 1000 * rank)}
    out = {"all_gather": comm.all_gather(mine), "gather": comm.gather(mine, dst=1),
           "reduce_mean": comm.reduce_dict({"a": float(rank + 1), "b": 2.0 * rank}),
           "reduce_sum": comm.reduce_dict({"a": float(rank + 1)}, average=False),
           "reduce_tensors": [comm.reduce_over_ranks(
               {"a": torch.tensor(float(rank + 1)),
                "b": torch.tensor(2.0 * rank, dtype=torch.float64)}, average=avg)
               for avg in (True, False)],
           "seed": comm.shared_random_seed(), "world": world}
    np.random.seed(100 + rank)                   # a seed each: the shared one is rank 0's
    out["seed_again"] = comm.shared_random_seed()
    np.random.seed(100)
    out["rank0_draw"] = int(np.random.randint(2 ** 31))
    # gather_rows: rank order forward; backward the own rows of the incoming
    # gradient times W
    x = torch.arange(6.0).reshape(3, 2).add(10 * rank).requires_grad_(True)
    y = dist.gather_rows(x)
    (y * torch.arange(1.0, y.numel() + 1).reshape(y.shape)).sum().backward()
    out["gathered"], out["gather_grad"] = y.detach(), x.grad
    out["local_rows"] = dist.local_rows(torch.arange(8.0).reshape(4, 2))
    out["batch_mean"] = dist.batch_mean(torch.tensor(3.0 + rank), torch.tensor(2 + rank))
    comm.synchronize()
    return out


def main() -> int:
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    spec = torch.load(spec_path, weights_only=False)
    torch.set_num_threads(1)
    dist.init_distributed("cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    if spec.get("grid"):
        mesh.init_grid(*spec["grid"])
    rank = comm.get_rank()
    print(f"rank {rank} of {comm.get_world_size()} joined", flush=True)
    case = spec["case"]
    if case == "raise":
        if rank == 1:
            raise ValueError("rank 1 fails on purpose")
        comm.synchronize()                      # waits for a rank that is gone
        return 0
    if case == "hang":
        if rank == 1:
            time.sleep(3600)
        comm.synchronize()                      # waits for the rank that sleeps
        return 0
    result = {"comm": run_comm,
              "trainer": lambda s: {"eval": run_eval(s), "preempt": run_preempt(s["preempt"])},
              "steps": lambda s: [run_steps(r) for r in s["runs"]]}[case](spec)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy()
    print(f"rank {rank}: {case} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
