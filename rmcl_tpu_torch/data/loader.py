"""Host input pipeline: sharded sampling + threaded prefetch loader (the
port's own copy of the JAX package's ``data/loader.py``).

Replaces the reference's torch DataLoader + DistributedSampler stack
(reference vilt/datamodules/multitask_datamodule.py:35-51): each host
reads only its own shard of every epoch permutation
(``rank::world_size``, same slicing DistributedSampler uses), workers
are a thread pool decoding/transforming ahead of the training loop, and
batches come out as plain numpy dicts for the Trainer to move to the
device.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Sequence

import numpy as np

from rmcl_tpu_torch.data.rng import batch_rng, batch_seed, sample_rng

# fork-inherited worker state for the process-pool mode: set by the
# parent immediately before Pool creation; children receive it through
# the fork snapshot, so the dataset (pyarrow mmaps, tokenizer) is never
# pickled.  Read-only in workers.  Keyed by a per-pool token so two
# live loaders (train + val) never clobber each other's entry — a pool
# respawning a dead worker re-forks from the CURRENT parent state, and
# with a shared flat dict the respawned child would inherit the other
# loader's (or an empty) state.
_FORK_STATE: Dict[int, Dict[str, Any]] = {}
_FORK_TOKEN = itertools.count(1)


def _proc_make_batch(args):
    token, bidx, valid, seed = args
    # Per-BATCH deterministic reseeding: all forked children share one
    # RNG snapshot, so without this every worker would replay the same
    # mask/false-draw stream (correlated batches).  Seeding by (loader
    # seed, epoch, batch index, role — data/rng.py batch_seed) makes
    # the stream invariant to the worker count AND identical to the
    # thread loader's — stronger than torch DataLoader's per-worker
    # base_seed+worker_id, which changes data when num_workers changes.
    import random as _random
    _random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    state = _FORK_STATE[token]
    ds = state["dataset"]
    base_seed, epoch = state["sample_seed"]
    samples = []
    for i in bidx:
        # same per-sample streams as the thread path (data/rng.py), so
        # thread and process loaders produce identical samples
        with sample_rng(base_seed, epoch, int(i)):
            samples.append(ds[int(i)])
    # collate-time RNG (MLM masks) scoped to the same batch seed the
    # thread path uses — thread/process mask parity by construction
    with batch_rng(seed):
        batch = state["collate"](samples)
    batch["_valid"] = valid
    return batch


class ConcatDataset:
    """Concatenation of datasets (reference uses torch ConcatDataset,
    multitask_datamodule.py:35-37)."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = [d for d in datasets if len(d) > 0]
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[di][idx - int(self.offsets[di])]

    @property
    def corpus(self) -> List[str]:
        out: List[str] = []
        for d in self.datasets:
            out.extend(getattr(d, "corpus", []))
        return out


class DataLoader:
    """Deterministic epoch iteration with per-host sharding and threaded
    prefetch.  `set_epoch` reshuffles (DistributedSampler semantics)."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Callable[[List[Dict[str, Any]]], Dict[str, Any]],
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 4, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 num_worker_procs: int = 0, role: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.num_worker_procs = num_worker_procs if hasattr(os, "fork") else 0
        # role salts the per-batch collate RNG (data/rng.py batch_seed)
        # so concurrently-live loaders sharing one config seed (train /
        # val / test) never replay each other's mask streams
        self.role = role
        self.epoch = 0
        self.skip_batches = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0):
        """`skip_batches` fast-forwards iteration past the first N
        batches of this epoch WITHOUT decoding them (mid-epoch
        preemption resume: the epoch permutation is a pure function of
        seed+epoch, so skipping reproduces the interrupted epoch's
        exact continuation).  `len()` still reports the full epoch."""
        self.epoch = epoch
        self.skip_batches = skip_batches

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        idx = order[self.process_index::self.process_count]
        n_real = len(idx)
        # Every host must iterate the SAME number of batches: hosts run
        # collectives in lockstep, and the trainer's resume math
        # (train/loop.py) assumes steps_per_epoch == len(loader) on
        # every host.  order[pi::pc] shards differ by one element when
        # pc does not divide n, so equalize:
        if self.drop_last:
            # truncate every shard to the common floor(n/pc) — batches
            # per host == n // (pc*bs) exactly (at most pc-1 samples
            # dropped per epoch, reshuffled back in the next epoch)
            idx = idx[: n // self.process_count]
        else:
            # pad by wrap-around up to the common ceil(n/pc), then to a
            # batch multiple, so every batch is full-size/static — the
            # same repetition DistributedSampler applies to make the
            # set divisible (reference multitask_datamodule.py:44-47);
            # rows past n_real are masked invalid downstream so each
            # sample is still counted exactly once globally
            common = -(-n // self.process_count)
            total = -(-common // self.batch_size) * self.batch_size
            if n_real == 0:
                # this host's strided shard is empty (n < process_count):
                # feed row 0 as a fully-masked placeholder so the host
                # still iterates the same `total // batch_size` batches
                # as everyone else (hosts run collectives in lockstep)
                idx = np.zeros(total, dtype=np.int64)
            elif total > n_real:
                reps = -(-total // n_real)
                idx = np.concatenate([idx] * reps)[:total]
        return idx, n_real

    def __len__(self) -> int:
        # closed form — must stay consistent with _indices()'s shard
        # equalization.  Computing it arithmetically matters: Trainer
        # setup calls len() on a throwaway loader, and materializing the
        # O(n) epoch permutation just to count batches permutes a
        # multi-million-entry array on real corpora.
        n = len(self.dataset)
        if self.drop_last:
            return (n // self.process_count) // self.batch_size
        common = -(-n // self.process_count)
        return -(-common // self.batch_size)

    def _batches(self) -> Iterator[np.ndarray]:
        idx, n_real = self._indices()
        end = len(idx) // self.batch_size * self.batch_size
        assert end // self.batch_size == len(self), \
            "loader __len__ out of sync with _indices"
        start = min(self.skip_batches * self.batch_size, end)
        for s in range(start, end, self.batch_size):
            # validity mask so wrap-around rows are evaluated but never
            # counted (the reference's DistributedSampler evaluates each
            # sample exactly once per process).  First element is the
            # ABSOLUTE batch index in the epoch (stable under
            # skip_batches fast-forward) — the collate RNG seed.
            valid = np.arange(s, s + self.batch_size) < n_real
            yield s // self.batch_size, idx[s:s + self.batch_size], valid

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_worker_procs > 0:
            yield from self._iter_procs()
            return
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def get_one(i):
            # deterministic per-sample draw stream (false draws, retry,
            # randaug) keyed by (seed, epoch, dataset index): identical
            # runs see identical samples under any worker count, and
            # mid-epoch resume replays the exact stream (data/rng.py)
            with sample_rng(self.seed, self.epoch, int(i)):
                return self.dataset[int(i)]

        def make_batch(k, bidx, valid):
            samples = list(pool.map(get_one, bidx))
            # collate-time RNG (MLM masks) scoped per batch position:
            # pure function of (seed, epoch, batch, role) — mid-epoch
            # resume replays the exact masks, and the process loader
            # produces identical batches (it uses the same seed)
            with batch_rng(batch_seed(self.seed, self.epoch, k, self.role)):
                batch = self.collate_fn(samples)
            # host-only metadata (underscore keys stay off-device)
            batch["_valid"] = valid
            return batch

        def producer():
            try:
                for k, bidx, valid in self._batches():
                    if stop.is_set():
                        return
                    out_q.put(make_batch(k, bidx, valid))
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = out_q.get()
                if b is None:
                    break
                yield b
        finally:
            stop.set()
            pool.shutdown(wait=False)

    def _iter_procs(self) -> Iterator[Dict[str, Any]]:
        """Fork-based worker processes (the reference's torch DataLoader
        num_workers model): each batch's decode+collate runs in a child
        process, sidestepping the GIL ceiling of the thread pool (the
        sample work holds the GIL ~32% of the time — measured in
        scripts/measure_loader.py — capping threads at ~3 effective
        workers no matter the vCPU count).  The dataset reaches the
        children through the fork snapshot (pyarrow mmaps are
        fork-safe read-only); only index arrays go out and one batch
        dict comes back per task.  Epoch order is kept by a hand-rolled
        bounded apply_async window (deque below): results are consumed
        strictly in submission order, and at most
        ``num_worker_procs + prefetch`` batches are in flight — Pool's
        own `imap` would let its feeder thread race the whole epoch
        ahead of a slow consumer (unbounded decoded-batch memory).
        """
        from collections import deque

        import multiprocessing as mp

        ctx = mp.get_context("fork")
        token = next(_FORK_TOKEN)
        _FORK_STATE[token] = {
            "dataset": self.dataset,
            "collate": self.collate_fn,
            "sample_seed": (self.seed, self.epoch),
        }
        pool = ctx.Pool(self.num_worker_procs)

        def tasks():
            for k, bidx, valid in self._batches():
                yield (token, bidx, valid,
                       batch_seed(self.seed, self.epoch, k, self.role))

        try:
            # bounded in-flight window (imap's feeder would decode the
            # whole epoch ahead of a slow consumer — unbounded memory)
            it = tasks()
            pend = deque(
                pool.apply_async(_proc_make_batch, (t,))
                for t in itertools.islice(
                    it, self.num_worker_procs + self.prefetch))
            while pend:
                out = pend.popleft().get()
                nxt = next(it, None)
                if nxt is not None:
                    pend.append(pool.apply_async(_proc_make_batch, (nxt,)))
                yield out
        finally:
            pool.terminate()
            pool.join()
            _FORK_STATE.pop(token, None)
