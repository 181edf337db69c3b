"""Training orchestration (port of the JAX package's ``train/loop.py``): the
reference's pl.Trainer + run.py path (reference run.py:92-118) as one
explicit loop, with the greedy attacker's construction.

Per micro-step:
  1. host: next collated numpy batch (``data/loader.py``);
  2. host: the greedy attack's word/candidate tables for the attacked step
     (``FusedGreedyAttack.prep_tables``), or the whole attack for the host
     attacker, on a worker thread one batch ahead (``host_prefetch``);
  3. device: the step (``train/step.py``): for the pretraining tasks the
     MLM, MPP and ITM forwards (ITM with its optimal-transport alignment),
     the backward and the optimizer; for ``task_moco`` the momentum
     update, key forward, greedy attack, PGD, the four views, the backward,
     the optimizer once per accumulation cycle, the enqueue; for
     ``task_barlowtwins`` the key forward, greedy attack, PGD, three views,
     the backward and the optimizer; for the downstream tasks the greedy
     attack, PGD, the clean and attacked forwards, the backward and the
     optimizer;
  4. host: the step's scalar metrics, read from the device once per log
     interval (``Trainer.host_reads``), into the epoch's ``MetricBag``.

Validation runs the eval step with the same adversarial views, writes the
VQA submission on the test split (``eval/vqa.py``) and computes the IR/TR
recall when ``cfg.get_recall_metric`` (``eval/retrieval.py``, attacked when
``irtr_attacked`` is active); the epoch's end assembles ``val/the_metric``
(``MetricBag``) and saves ``last`` and ``best`` (``train/checkpoint.py``).
SIGTERM or ``request_preemption()`` commits a mid-epoch ``last`` and leaves
``fit``; a Trainer with ``resume_from`` restores it and draws the same
batches, masks and dropout seeds as the run it continues.

With ``cfg.augmentation`` the benign views take the attacks' place: EDA
text views and SimCLR image views (``data/augmentation.py``), attached to the
host batch as ``attacked_text_ids`` / ``attacked_text_masks`` and
``augmented_image``; no greedy attack and no PGD runs.

Over several processes (``python -m torch.distributed.run`` around ``cli.run
with``, ``parallel/dist.py:init_distributed``), each rank trains on its
``rank::world`` shard of the data (the datamodule's process index and
count) at ``batch_size // world`` pairs per step unless
``per_device_batchsize`` sets it, the accumulation counted on the global
batch; the step couples the ranks (``train/step.py``); the preemption flag
is any-reduced every ``cfg.preempt_sync_every`` micro-steps, so that every
rank leaves the loop at the same step; the metric bags sum over ranks
before their epoch's end; validation gathers the VQA file and the recall's
score rows; rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from rmcl_tpu_torch.attacks import greedy as G
from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
from rmcl_tpu_torch.core.buckets import bucket_enabled, text_bucket
from rmcl_tpu_torch.data.datamodule import MultitaskDataModule
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.eval.metrics import MetricBag, Scalar
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.parallel import comm
from rmcl_tpu_torch.train.checkpoint import CheckpointManager, load_initial_params
from rmcl_tpu_torch.train.logging import MetricLogger
from rmcl_tpu_torch.train.step import (
    create_train_state, make_attacked_train_step, make_eval_step, make_train_step,
    resolve_max_steps, training_device)


def build_greedy_attacker(cfg, model, tokenizer):
    """The framework's greedy attacker (reference vilt_module.py:102-107), or
    None when no greedy framework is active or the counter-fitted vectors
    are missing."""
    framework = G.greedy_attack_framework(cfg)
    if framework is None:
        return None
    if cfg.synonym == "cos_sim":
        if not os.path.isfile(cfg.embedding_path):
            print(f"[train] text_view requested but embedding_path "
                  f"{cfg.embedding_path!r} missing — text view disabled",
                  file=sys.stderr)
            return None
        syn = G.SynonymTable(cfg.embedding_path, cfg.n_candidates,
                             cfg.sim_thred, cache_path=cfg.sim_path or None,
                             device=next(model.parameters()).device)
    else:
        syn = G.WordnetSynonyms(cfg.n_candidates)
    attacker = G.GREEDY_ATTACKERS[framework](cfg, model, tokenizer, syn)
    if cfg.greedy_impl == "fused":
        attacker = FusedGreedyAttack(attacker)
    return attacker


def make_greedy_extras_fn(cfg, model) -> Optional[Callable]:
    """``fn(ts, batch) -> extras`` for the active framework, or None."""
    framework = G.greedy_attack_framework(cfg)
    if framework is None:
        return None
    return lambda ts, batch: G.greedy_attack_extras(cfg, ts.model, framework, batch,
                                                    ts.block_matrices)


# ------------------------------------------------------------ the Trainer
class _ScratchBag:
    """Thread-private stand-in for MetricBag.extra used by prefetched
    attack calls; merged into train_metrics on the main thread only when
    the batch actually trains."""

    def __init__(self):
        self.extra: Dict[str, Scalar] = {}


_TEXT_KEY_SUFFIXES = ("_ids", "_masks", "_labels", "_ids_mlm", "_labels_mlm")


def bucket_text_batch(batch: Dict[str, Any], max_text_len: int) -> Dict[str, Any]:
    """Slice every text-grid key to the smallest /8 bucket covering all
    valid tokens (PARITY #31).  Exact: the dropped columns are all-pad /
    all -100 and attention-masked."""
    mask_keys = [k for k in batch
                 if "text" in k and k.endswith("_masks")
                 and getattr(batch[k], "ndim", 0) == 2
                 and batch[k].shape[1] == max_text_len]
    if not mask_keys:
        return batch
    tb = max(int(np.asarray(batch[k]).sum(axis=1).max()) for k in mask_keys)
    tb = text_bucket(tb, max_text_len)
    if tb == max_text_len:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if ("text" in k and getattr(v, "ndim", 0) == 2
                and v.shape[1] == max_text_len
                and k.endswith(_TEXT_KEY_SUFFIXES)):
            out[k] = v[:, :tb]
    return out


def _device_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``; underscore keys
    (``_valid``) and host lists (captions, indices) stay behind."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
                               device=device)
            for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor)) and not k.startswith("_")}


def step_generator(seed: int, steps_done: int) -> torch.Generator:
    """The CPU generator of micro-step ``steps_done``: a pure function of
    (seed, steps_done), the counterpart of the JAX package's
    ``jax.random.fold_in(rng, steps_done)``, so a preempted and resumed run
    draws the dropout seeds of the run it continues."""
    return torch.Generator().manual_seed(seed * 1_000_003 + steps_done)


def preempt_consensus(cfg, requested: bool, steps_done: int) -> bool:
    """Step-boundary preemption decision (SURVEY §5.3).  One process: the
    local flag.  Several: the flag any-reduced across ranks every
    ``cfg.preempt_sync_every`` micro-steps (and False between), so that
    every rank leaves the step loop, and enters the checkpoint save's
    collectives, at the same step; a rank acting on its own flag would
    leave the others waiting in the next step's collectives.  Every rank
    must call it after every micro-step."""
    if not cfg.graceful_preemption:
        return False
    if comm.get_world_size() == 1:
        return bool(requested)
    if steps_done % max(cfg.preempt_sync_every, 1):
        return False
    return any(comm.all_gather(bool(requested)))


class Trainer:
    """``Trainer(cfg, workdir, datamodule=None, vocab_path=None,
    device=None)``: ``setup()`` then ``fit()``; ``validate()`` alone with
    ``test_only``.  Runs on the first CUDA device unless ``device`` says
    otherwise; without a card only ``device="cpu"`` runs (the plain ops).
    Over several processes: after ``parallel/dist.py:init_distributed``,
    each rank with the device that returned; the default datamodule takes
    the rank and the world size as its process index and count."""

    def __init__(self, cfg, workdir: str = "result",
                 datamodule: Optional[MultitaskDataModule] = None,
                 vocab_path: Optional[str] = None, device=None):
        self.cfg = cfg
        self.workdir = os.path.join(workdir, cfg.exp_name)
        self.device = training_device(device)
        self.dm = datamodule or MultitaskDataModule(
            cfg, vocab_path=vocab_path, process_index=comm.get_rank(),
            process_count=comm.get_world_size())
        self.steps_done = 0
        self.host_reads = 0          # device -> host reads of the step metrics
        self._preempt_requested = False
        self._pending: List[Dict[str, torch.Tensor]] = []

    # ----------------------------------------------------------- assembly
    def setup(self, model: Optional[ViLT] = None):
        """``model``: the weights to train (default: ``ViLT`` from
        ``cfg.seed``, then ``cfg.load_path``)."""
        cfg = self.cfg
        self.dm.setup()
        world = comm.get_world_size()
        per_host = cfg.per_device_batchsize or max(cfg.batch_size // world, 1)
        self.per_host_batch = per_host
        # from the loader's own length, so resume's epoch/skip arithmetic
        # can never drift from what the loader yields (the loader equalises
        # the shards: every rank's length is the same)
        steps_per_epoch = max(len(self.dm.train_loader(per_host)), 1)
        # gradient accumulation: micro-batches per optimizer step (reference
        # run.py:86-88,105), when per_device_batchsize caps the global step
        # batch below cfg.batch_size
        world_batch = per_host * world
        self.accum_steps = (max(cfg.batch_size // world_batch, 1)
                            if cfg.per_device_batchsize else 1)
        # max_steps and the schedule count OPTIMIZER steps; steps_per_epoch
        # and steps_done count micro-batches
        self.max_steps = resolve_max_steps(
            cfg, max(steps_per_epoch // self.accum_steps, 1))
        self.steps_per_epoch = steps_per_epoch

        if model is None:
            model = load_initial_params(
                cfg, ViLT(cfg).init(torch.Generator().manual_seed(cfg.seed)))
        self.ts = create_train_state(cfg, max_steps=self.max_steps, model=model,
                                     device=self.device, accum=self.accum_steps)
        self.greedy = self.text_augment = self.image_augment = None
        if cfg.augmentation:
            # benign views replace the attacks (reference objectives.py:277-279,
            # 320-321)
            from rmcl_tpu_torch.data.augmentation import ImageAugmentation, TextAugmentation
            if cfg.text_view:
                self.text_augment = TextAugmentation(cfg, self.dm.tokenizer)
            if cfg.image_view:
                self.image_augment = ImageAugmentation(
                    self.dm.datasets["train"]["concat"].datasets[0], size=cfg.image_size)
        elif cfg.text_view:
            self.greedy = build_greedy_attacker(cfg, self.ts.model, self.dm.tokenizer)
        # train/eval text bucket: off whenever a text view or augmentation
        # supplies (B, max_text_len) attacked ids that a sliced batch would mismatch
        self._text_bucket = (bucket_enabled(cfg, "train") and not cfg.text_view
                             and not cfg.augmentation)
        # the attack inside the step whenever the attacker is the fused one
        # (the port has no fuse_attack_step=False path)
        self._fused_step = isinstance(self.greedy, FusedGreedyAttack)
        if self._fused_step:
            self.step_fn = make_attacked_train_step(cfg, self.ts, self.greedy,
                                                    max_steps=self.max_steps)
        else:
            self.step_fn = make_train_step(cfg, self.ts, max_steps=self.max_steps)
        self.eval_fn = make_eval_step(cfg, self.ts)
        self.ckpt = CheckpointManager(self.workdir)
        if cfg.resume_from and self.ckpt.has("last"):
            self.ckpt.restore(self.ts, "last")
            self.steps_done = self.ts.step
        self._extras_fn = None
        self.epoch = 0
        self.train_metrics = MetricBag(cfg.loss_names)
        self.val_metrics = MetricBag(cfg.loss_names)
        self.logger = MetricLogger(self.workdir, enabled=comm.is_main_process())

    # ------------------------------------------------------------- attack
    def _prefetch_attack(self, raw: Dict[str, Any]):
        """Worker-thread wrapper around `_attach_text_attack`: attack
        telemetry goes into a private scratch bag, merged by the caller only
        when the batch trains."""
        scratch = _ScratchBag()
        return self._attach_text_attack(raw, bag=scratch), scratch

    def _merge_scratch(self, scratch: _ScratchBag):
        for k, s in scratch.extra.items():
            dst = self.train_metrics.extra.setdefault(k, Scalar())
            dst.value += s.value
            dst.n += s.n

    def _attach_text_attack(self, batch: Dict[str, Any], bag=None,
                            for_train: bool = True) -> Dict[str, Any]:
        """The host's part of a batch's views: the benign views when
        ``cfg.augmentation`` (the augmented ids and image); else the greedy
        attack's tables for the attack inside the step, or (host attacker,
        and validation) the attacked ids themselves."""
        if self.text_augment is not None and "text" in batch:
            _, ids, masks = self.text_augment.augment(batch["text"], epoch=self.epoch)
            batch = dict(batch, attacked_text_ids=ids, attacked_text_masks=masks)
        if self.image_augment is not None and "img_index" in batch:
            aug = self.image_augment.augment_indices(batch["img_index"],
                                                     self.cfg.image_bucket_hw)
            if self.cfg.image_layout == "patch":
                aug = hwc_to_patch_rows(aug, self.cfg.patch_size)
            batch = dict(batch, augmented_image=aug)
        if self.greedy is None:
            return batch
        if self._fused_step and for_train:
            return dict(batch, **self.greedy.prep_tables(batch["text_ids"]))
        db = _device_batch(batch, self.device)
        if self._extras_fn is None:
            self._extras_fn = make_greedy_extras_fn(self.cfg, self.ts.model)
        out = self.greedy.adv_attack_samples(db, self._extras_fn(self.ts, db))
        batch = dict(batch, attacked_text_ids=out["txt_input_ids"],
                     attacked_text_masks=out["text_masks"])
        bag = bag if bag is not None else self.train_metrics
        bag.extra.setdefault("num_changes", Scalar()).update(out["num_changes"])
        bag.extra.setdefault("change_rate", Scalar()).update(out["change_rate"])
        return batch

    # ------------------------------------------------------------ metrics
    def _flush_metrics(self) -> Dict[str, np.ndarray]:
        """Every pending step's scalar metrics in ONE device -> host read, into
        the epoch's bag in step order; returns the last step's."""
        if not self._pending:
            return {}
        flat = torch.stack([v.float() for m in self._pending for v in m.values()])
        flat = flat.cpu().numpy()
        self.host_reads += 1
        i, last = 0, {}
        for m in self._pending:
            last = {k: flat[i + j] for j, k in enumerate(m)}
            i += len(m)
            self.train_metrics.update(last)
        self._pending.clear()
        return last

    # ------------------------------------------------------- preemption
    def request_preemption(self):
        """Ask fit() to stop at the next step boundary and commit a
        mid-epoch 'last' checkpoint.  Installed as the SIGTERM action while
        fit() runs on the main thread; callers may also call it directly."""
        self._preempt_requested = True

    @contextlib.contextmanager
    def _sigterm_guard(self):
        """The graceful-SIGTERM handler for the duration of fit() (main
        thread only: signal.signal is unavailable elsewhere)."""
        if (not self.cfg.graceful_preemption
                or threading.current_thread() is not threading.main_thread()):
            yield
            return

        def handler(signum, frame):
            print("[train] SIGTERM: checkpointing and exiting at the next step "
                  "boundary", flush=True)
            self.request_preemption()

        prev = signal.signal(signal.SIGTERM, handler)
        try:
            yield
        finally:
            signal.signal(signal.SIGTERM, prev)

    def _preempt_now(self) -> bool:
        return preempt_consensus(self.cfg, self._preempt_requested, self.steps_done)

    # --------------------------------------------------------------- run
    def fit(self):
        cfg = self.cfg
        # self.max_steps counts optimizer steps, the loop micro-batches
        limit = self.max_steps * self.accum_steps
        log_every = cfg.log_every_n_steps
        # resume: restart at the epoch the restored step sits in, skipping
        # the batches of that epoch already trained (the epoch permutation
        # is a pure function of seed + epoch)
        epoch = self.steps_done // max(self.steps_per_epoch, 1)
        resume_skip = self.steps_done - epoch * self.steps_per_epoch
        preempted = False
        self._preempt_requested = False
        t0 = time.time()
        # the host side of the attack for batch N+1 runs on a worker thread
        # while the device runs step N; over several processes only when that
        # side is the host's alone (the tables, the benign views): a host
        # attacker's device work has collectives, which must keep the main
        # thread's order
        host_only = self._fused_step or self.greedy is None
        pool = (ThreadPoolExecutor(max_workers=1)
                if cfg.host_prefetch and (comm.get_world_size() == 1 or host_only)
                and (self.greedy is not None or self.text_augment is not None
                     or self.image_augment is not None) else None)
        fut = None
        try:
            with self._sigterm_guard():
                while self.steps_done < limit and epoch < cfg.max_epoch:
                    self.epoch = epoch
                    loader = self.dm.train_loader(self.per_host_batch)
                    loader.set_epoch(epoch, skip_batches=resume_skip)
                    resume_skip = 0
                    it = iter(loader)
                    raw = next(it, None)
                    fut = (pool.submit(self._prefetch_attack, raw)
                           if pool is not None and raw is not None else None)
                    while raw is not None:
                        if self.steps_done >= limit:
                            break
                        if fut is not None:
                            batch, scratch = fut.result()
                            self._merge_scratch(scratch)
                        else:
                            batch = self._attach_text_attack(raw)
                        fut = None
                        if self._text_bucket:
                            batch = bucket_text_batch(batch, cfg.max_text_len)
                        db = _device_batch(batch, self.device)
                        metrics = self.step_fn(
                            db, step_generator(cfg.seed + 1, self.steps_done))
                        self.steps_done += 1
                        # the next batch's host attack starts now, after the
                        # step was issued and before the metrics are read
                        raw = next(it, None)
                        if pool is not None and raw is not None:
                            fut = pool.submit(self._prefetch_attack, raw)
                        self._pending.append(metrics)
                        if self.steps_done % log_every == 0:
                            last = self._flush_metrics()
                            dt = (time.time() - t0) / log_every
                            t0 = time.time()
                            self.logger.log(self.steps_done, last, prefix="train/")
                            print(f"[train] step {self.steps_done}/{limit} "
                                  f"loss={float(last['total_loss']):.4f} "
                                  f"lr={float(last['lr']):.2e} "
                                  f"{dt * 1e3:.0f} ms/step", flush=True)
                        if self._preempt_now():
                            preempted = True
                            break
                        if cfg.fast_dev_run:
                            break
                    # a prefetch for a batch that will not train: drained,
                    # its telemetry discarded
                    if fut is not None:
                        fut.result()
                        fut = None
                    self._flush_metrics()
                    if preempted:
                        self.ckpt.save_last(self.ts)
                        print(f"[train] preempted: 'last' checkpoint at micro-step "
                              f"{self.steps_done}; exiting fit()", flush=True)
                        break
                    tm = self.train_metrics.epoch_wrapup("train")
                    vm = self.validate()
                    self.logger.log(self.steps_done, tm, prefix="train_epoch/")
                    self.logger.log(self.steps_done, vm, prefix="val_epoch/")
                    print(f"[epoch {epoch}] train_the_metric="
                          f"{tm.get('train/the_metric', 0):.4f} "
                          f"val_the_metric={vm.get('val/the_metric', 0):.4f}",
                          flush=True)
                    # best first, so that 'last' holds the best score that
                    # a resumed run compares its next validation with
                    self.ckpt.maybe_save_best(self.ts, vm)
                    self.ckpt.save_last(self.ts)
                    epoch += 1
                    if cfg.fast_dev_run:
                        break
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return self.ts

    # ---------------------------------------------------------------- val
    def validate(self, split: str = "val") -> Dict[str, float]:
        """The eval step over the ``split`` loader (wrap-padded rows masked
        by ``_valid``) with the training's adversarial views (reference
        objectives.py:277-285); on the test split of a VQA task the
        submission file (``eval/vqa.py``, in ``cfg.log_dir``); with
        ``cfg.get_recall_metric`` (and not ``fast_dev_run``) the IR/TR recall
        (``eval/retrieval.py``).  No dropout, and PGD starts from zero; the
        pretraining tasks' ITM labels and MPP masks come from one CPU generator
        seeded with ``cfg.seed + 2``, as the JAX package's validation key is,
        drawn batch after batch."""
        cfg = self.cfg
        loader = (self.dm.val_loader(self.per_host_batch) if split == "val"
                  else self.dm.test_loader(self.per_host_batch))
        bag = self.val_metrics
        generator = torch.Generator().manual_seed(cfg.seed + 2)
        # the VQA test submission (reference vqa_test_step objectives.py:1519-1530,
        # vqa_test_wrapup :1537-1565)
        vqa_writer = None
        is_vqa = (cfg.loss_names.get("vqa", 0) >= 1
                  or cfg.loss_names.get("vqa_attacked", 0) >= 1)
        if split == "test" and is_vqa and self.dm.id2answer:
            from rmcl_tpu_torch.eval.vqa import VQASubmissionWriter
            model_name = (os.path.basename(cfg.load_path).rsplit(".", 1)[0]
                          if cfg.load_path else cfg.exp_name)
            vqa_writer = VQASubmissionWriter(self.dm.id2answer, out_dir=cfg.log_dir,
                                             model_name=model_name)
        for batch in loader:
            batch = self._attach_text_attack(batch, bag=bag, for_train=False)
            if self._text_bucket:
                batch = bucket_text_batch(batch, cfg.max_text_len)
            ret = self.eval_fn(_device_batch(batch, self.device), generator)
            valid = batch.get("_valid")
            # bf16 outputs (logits) widen to fp32 exactly: numpy has no bf16
            retl = {k: (v.detach().float() if v.is_floating_point() else v.detach())
                    .cpu().numpy() for k, v in ret.items()}
            bag.update(retl, valid=valid)
            if vqa_writer is not None and "qid" in batch:
                qids = list(batch["qid"])
                logits = retl.get("vqa_logits", retl.get("vqa_attacked_logits"))
                if valid is not None and not np.asarray(valid).all():
                    qids = [q for q, keep in zip(qids, valid) if keep]
                    logits = logits[np.asarray(valid, bool)]
                vqa_writer.update(qids, logits)
            if cfg.fast_dev_run:
                break
        if vqa_writer is not None:
            path = vqa_writer.finalize(process_index=comm.get_rank(),
                                       process_count=comm.get_world_size(),
                                       gather=comm.all_gather)
            if path:
                print(f"[vqa] submission written to {path}", flush=True)

        recall = None
        if cfg.get_recall_metric and not cfg.fast_dev_run:
            # every validation computes the recall (reference vilt_utils.py:90-96),
            # the attacked one when irtr_attacked is active (:91-94)
            from rmcl_tpu_torch.eval import retrieval
            if cfg.loss_names.get("irtr_attacked", 0) >= 1:
                recall = retrieval.compute_attacked_irtr_recall(
                    self, text_view=cfg.text_view, image_view=cfg.image_view)
            else:
                recall = retrieval.compute_irtr_recall(self)
        return bag.epoch_wrapup(split, recall=recall)
