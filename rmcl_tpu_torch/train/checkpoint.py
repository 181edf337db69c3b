"""Checkpoint/resume (port of the JAX package's ``train/checkpoint.py``).

Reference behavior (SURVEY.md §5.4): Lightning ModelCheckpoint (save_top_k=1
on val/the_metric, save_last) is constructed but dropped from the callbacks
(reference run.py:46-52,78), so the reference never saves top-k
checkpoints.  As in the JAX package, the *intended* semantics: keep the
best-by-metric checkpoint and the last one, and support resume (reference
`resume_from_checkpoint`, run.py:108).

A checkpoint is a directory of two ``torch.save`` files, not orbax:

  * ``model.pt``: ``{"state_dict": ...}``, the model's reference-named state
    dict (momentum twins, queue and pointer included) on the CPU — what
    ``serve.py:load_state_dict_file`` and the JAX package's
    ``compat/torch_loader.py:convert_state_dict`` read;
  * ``train.pt``: the optimizer's and the scheduler's state dicts, ``step``
    (the micro-steps done: the Trainer's ``steps_done``), the gradient
    accumulated so far in an unfinished accumulation cycle and the manager's
    best score so far, which ``restore`` takes back (so a resumed run does
    not replace a better ``best``).

Crash safety: each save goes to a unique directory ``<name>.<step>-<seq>``
(claimed with ``os.mkdir``, so two managers in one workdir never share one);
the logical name ("last"/"best") is a pointer file ``<NAME>.ptr`` swung by
``os.replace`` from a temporary name unique to the process and thread,
``<NAME>.ptr.<pid>-<thread>.tmp`` (the JAX package's shared
``<NAME>.ptr.tmp`` lets two writers rename each other's file away).  The
superseded directory is deleted only after the swing, so a crash at any
point leaves the previous checkpoint reachable and at most one orphaned
directory.  Saves are synchronous: ``wait`` has nothing to wait for.

Over several processes every rank calls ``save_last`` / ``maybe_save_best``
at the same step: under ZeRO-1 every rank first sends its shard of the
optimizer's state to rank 0 (``consolidate_state_dict``), an unfinished
accumulation cycle's gradient is saved as its mean over ranks (each rank
accumulates its own; the mean is the global cycle's so far, which every
rank continues from on resume), rank 0 alone writes, and a barrier follows,
so that no rank reads a pointer before it swings.  ``restore`` loads on
every rank.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading
from typing import Dict, Optional

import torch

from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.parallel import comm
from rmcl_tpu_torch.parallel.dist import sum_over_ranks
from rmcl_tpu_torch.serve import load_state_dict_file

MODEL_FILE = "model.pt"
TRAIN_FILE = "train.pt"


def _cpu(state):
    """A state dict's tensors detached onto the CPU (nested dicts, lists)."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, dict):
        return {k: _cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_cpu(v) for v in state)
    return state


def _ptr_file(workdir: str, logical: str) -> str:
    return os.path.join(workdir, logical.upper() + ".ptr")


def pointed_dir(workdir: str, logical: str) -> Optional[str]:
    """The directory name that ``<workdir>/<LOGICAL>.ptr`` names, when it
    exists; else None."""
    try:
        with open(_ptr_file(workdir, logical)) as f:
            target = f.read().strip()
    except OSError:
        return None
    return target if target and os.path.isdir(os.path.join(workdir, target)) else None


def resolve_checkpoint_dir(load_path: str) -> Optional[str]:
    """Resolve a load_path through the pointer scheme: a checkpoint
    directory itself (it holds ``model.pt``), a workdir holding ``LAST.ptr``
    / ``BEST.ptr``, or a logical ``<workdir>/last`` / ``<workdir>/best``
    path.  Returns the concrete directory, or None (a state-dict file, not a
    checkpoint directory)."""
    if os.path.isdir(load_path):
        if os.path.isfile(os.path.join(load_path, MODEL_FILE)):
            return load_path
        workdir, names = load_path, ("last", "best")
    else:
        workdir = os.path.dirname(os.path.normpath(load_path)) or "."
        names = [os.path.basename(os.path.normpath(load_path))]
        if names[0] not in ("last", "best"):
            return None
    for logical in names:
        target = pointed_dir(workdir, logical)
        if target:
            return os.path.join(workdir, target)
    return None


# where the MLM / ITM heads are grafted from, relative to the working directory
PRETRAIN_HEAD_FILES = ("models_weight/vilt_200k_mlm_itm.ckpt",
                       "../models_weight/vilt_200k_mlm_itm.ckpt")
MLM_HEAD_KEYS = ("mlm_score.bias", "mlm_score.transform.dense.weight",
                 "mlm_score.transform.dense.bias", "mlm_score.transform.LayerNorm.weight",
                 "mlm_score.transform.LayerNorm.bias", "mlm_score.decoder.weight")
ITM_HEAD_KEYS = ("itm_score.fc.weight", "itm_score.fc.bias")


def graft_pretrain_heads(sd: Dict[str, torch.Tensor], pretrain_sd: Dict[str, torch.Tensor],
                         loss_names: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """``sd`` with the MLM head's entries (when the ``mlm`` weight is > 0) and
    the ITM head's (when ``itm``'s is) taken from ``pretrain_sd`` (reference
    vilt_module.py:134-160)."""
    sd = dict(sd)
    for name, keys in (("mlm", MLM_HEAD_KEYS), ("itm", ITM_HEAD_KEYS)):
        if loss_names.get(name, 0) > 0:
            sd.update({k: pretrain_sd[k] for k in keys})
    return sd


def load_initial_params(cfg, model: ViLT) -> ViLT:
    """cfg.load_path handling (reference vilt_module.py:134-160): a
    checkpoint of this package (``resolve_checkpoint_dir``) or a reference-named
    state dict (a reference ``.ckpt``, plain or under ``"state_dict"``),
    loaded through ``ViLT.load_reference_state_dict`` as the JAX package's
    ``load_initial_params`` merges it into the fresh init: parts the file
    lacks (another task's head, the momentum twins) keep the model's own
    values, NLVR2's third token type and a pos-embed of another grid are
    repaired, entries of parts the model does not build are skipped; a file
    is read as the JAX package's conversion reads one
    (``reference_file``).  A reference state dict first takes the MLM / ITM
    heads from the first of ``PRETRAIN_HEAD_FILES`` that exists, when the
    ``mlm`` or ``itm`` loss weight is > 0 (``graft_pretrain_heads``)."""
    if not cfg.load_path:
        return model
    ckpt_dir = resolve_checkpoint_dir(cfg.load_path)
    path = os.path.join(ckpt_dir, MODEL_FILE) if ckpt_dir else cfg.load_path
    sd = load_state_dict_file(path)
    graft = None
    if not ckpt_dir and (cfg.loss_names.get("mlm", 0) > 0 or cfg.loss_names.get("itm", 0) > 0):
        graft = next((f for f in PRETRAIN_HEAD_FILES if os.path.isfile(f)), None)
    if graft:
        sd = graft_pretrain_heads(sd, load_state_dict_file(graft), cfg.loss_names)
    skipped = model.load_reference_state_dict(sd, reference_file=not ckpt_dir)
    print(f"[rmcl_tpu_torch] loaded {path} ({len(skipped)} entries not used"
          f"{', heads grafted from ' + graft if graft else ''})", file=sys.stderr)
    return model


class CheckpointManager:
    def __init__(self, workdir: str, monitor: str = "val/the_metric"):
        self.workdir = os.path.abspath(workdir)
        self.monitor = monitor
        self.best_score: Optional[float] = None
        os.makedirs(self.workdir, exist_ok=True)
        # resume the unique-dir sequence past anything already on disk
        self._seq = self._scan_seq()

    def _scan_seq(self) -> int:
        seq = 0
        for d in os.listdir(self.workdir):
            _, _, tail = d.rpartition("-")
            if tail.isdigit() and os.path.isdir(os.path.join(self.workdir, d)):
                seq = max(seq, int(tail))
        return seq

    def _path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    # ------------------------------------------------- pointer plumbing
    def _write_ptr(self, logical: str, dirname: str):
        ptr = _ptr_file(self.workdir, logical)
        tmp = f"{ptr}.{os.getpid()}-{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(dirname)
        os.replace(tmp, ptr)

    def _claim_dir(self, logical: str, step: int) -> str:
        while True:
            self._seq += 1
            dirname = f"{logical}.{step}-{self._seq}"
            try:
                os.mkdir(self._path(dirname))
                return dirname
            except FileExistsError:    # another manager's, or an orphan of a crash
                continue

    def _save(self, logical: str, ts):
        world = comm.get_world_size()
        if hasattr(ts.optimizer, "consolidate_state_dict"):     # ZeroRedundancyOptimizer
            ts.optimizer.consolidate_state_dict(to=0)
        acc = ts.acc_grads
        if acc is not None and world > 1:
            acc = [sum_over_ranks(a) / world for a in acc]
        if comm.is_main_process():
            dirname = self._claim_dir(logical, ts.step)
            path = self._path(dirname)
            torch.save({"state_dict": _cpu(ts.model.state_dict())},
                       os.path.join(path, MODEL_FILE))
            torch.save({"optimizer": _cpu(ts.optimizer.state_dict()),
                        "scheduler": ts.scheduler.state_dict(),
                        "step": int(ts.step),
                        "acc_grads": _cpu(acc),
                        "best_score": self.best_score},
                       os.path.join(path, TRAIN_FILE))
            old = pointed_dir(self.workdir, logical)
            self._write_ptr(logical, dirname)
            if old and old != dirname:
                shutil.rmtree(self._path(old), ignore_errors=True)
        comm.synchronize()

    # ---------------------------------------------------------- public
    def wait(self):
        """Saves are synchronous: nothing is pending when ``save_last`` returns."""

    def save_last(self, ts):
        self._save("last", ts)

    def maybe_save_best(self, ts, metrics: dict) -> bool:
        score = metrics.get(self.monitor)
        if score is None:
            return False
        if self.best_score is None or score > self.best_score:
            self.best_score = float(score)
            self._save("best", ts)
            return True
        return False

    def checkpoint_dir(self, name: str = "last") -> Optional[str]:
        """The directory that holds ``name`` now, or None."""
        target = pointed_dir(self.workdir, name)
        return self._path(target) if target else None

    def restore(self, ts, name: str = "last"):
        """Load ``name`` into ``ts`` in place (model, optimizer, scheduler,
        step, accumulated gradient), take back the best score it was saved
        with, and return ``ts``."""
        path = self.checkpoint_dir(name)
        if path is None:
            raise FileNotFoundError(f"no {name!r} checkpoint in {self.workdir}")
        dev = next(ts.model.parameters()).device
        model = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                           weights_only=True)
        ts.model.load_state_dict(model["state_dict"])
        train = torch.load(os.path.join(path, TRAIN_FILE), map_location=dev,
                           weights_only=True)
        ts.optimizer.load_state_dict(train["optimizer"])
        ts.scheduler.load_state_dict(train["scheduler"])
        ts.step = train["step"]
        self.best_score = train["best_score"]
        if ts.acc_grads is not None:
            for acc, saved in zip(ts.acc_grads, train["acc_grads"]):
                acc.copy_(saved)
        ts.refresh_block_matrices()
        return ts

    def has(self, name: str = "last") -> bool:
        return pointed_dir(self.workdir, name) is not None
