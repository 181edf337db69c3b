"""Per-sample deterministic host RNG for the data pipeline (the port's own
copy of the JAX package's ``data/rng.py``: the same seeds, so the same
numbers).

The reference draws false images/texts, retry indices, RandAugment
parameters, and EDA choices from Python's GLOBAL `random` module
(reference base_dataset.py:93-165, randaug.py, eda.py) — a stream that
interleaves nondeterministically across DataLoader workers, so two
identical runs see different data.  Here every per-sample draw goes
through `srandom`, a proxy that prefers a contextvar-scoped
`random.Random` seeded by (loader seed, epoch, sample index):

  * identical runs produce identical samples under ANY worker count,
    thread or process pool;
  * mid-epoch preemption resume replays the interrupted epoch's exact
    draw stream (the seed is a pure function of position, upgrading
    PARITY #29's "host-deterministic pipelines" qualifier);
  * the streams differ from the reference's global stream — the same
    non-contractual divergence class as PARITY #15 (the draws are
    i.i.d. uniform either way).

Outside a loader context the proxy falls back to the global module
(demos / ad-hoc use keep reference behavior).  contextvars are
per-thread, so pool threads running different samples never share a
stream.

COLLATE-time RNG (the MLM mask streams) gets the same treatment at
batch granularity: the loader scopes each collate call with
``batch_rng(batch_seed(seed, epoch, batch_index, role))`` and the
MLMCollator draws from the scoped streams when present — so mask
patterns are a pure function of batch position (mid-epoch resume
replays them exactly), identical between the thread and process
loaders, and the train/val/test loaders (``role``) can never collide
even when live concurrently.
"""

from __future__ import annotations

import contextlib
import contextvars
import random as _global_random

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "rmcl_sample_rng", default=None)


class _Proxy:
    """Attribute proxy: contextvar Random if set, else the global
    `random` module."""

    def __getattr__(self, name):
        rng = _CTX.get()
        return getattr(rng if rng is not None else _global_random, name)


srandom = _Proxy()


def sample_seed(seed: int, epoch: int, index: int) -> int:
    # the index multiplier must exceed any dataset length or (epoch,
    # index) pairs alias — (e, i + M) replays (e + 1, i)'s exact
    # stream, correlating augmentations across epochs (the combined
    # GCC+SBU+COCO+VG pretraining corpus is ~5M captions).  2**42
    # clears any realistic corpus; Python ints are unbounded and
    # Random() hashes the full value.
    return (seed * 1_000_003 + epoch) * 2 ** 42 + index


@contextlib.contextmanager
def sample_rng(seed: int, epoch: int, index: int):
    """Scope `srandom` to a deterministic per-sample stream."""
    rng = _global_random.Random(sample_seed(seed, epoch, index))
    tok = _CTX.set(rng)
    try:
        yield
    finally:
        _CTX.reset(tok)


# --------------------------------------------------------------------------
# Per-BATCH streams for collate-time consumers (MLM masking).

_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "rmcl_batch_rng", default=None)


def batch_seed(seed: int, epoch: int, batch_index: int,
               role: int = 0) -> int:
    """Deterministic per-batch seed for collate-time RNG.

    Same anti-aliasing layout as `sample_seed`: the batch index
    occupies the low 2**42 (no epoch can have more batches), the epoch
    the next 2**20, and `role` separates concurrently-live loaders
    (train=0 / val=1 / test=2) sharing one config seed — a flat
    ``seed + epoch·K + batch`` scheme aliases across epochs as soon as
    an epoch has more than K batches, replaying identical mask streams.
    """
    return (((seed * 1_000_003 + role) * 2 ** 20 + epoch) * 2 ** 42
            + batch_index)


@contextlib.contextmanager
def batch_rng(seed: int):
    """Scope collate-time RNG consumers to streams seeded by the batch
    position.  The scope holds the SEED; consumers create their stream
    objects lazily via `get_batch_streams` exactly once per scope, so a
    batch with several text keys keeps sequential (non-replaying) draws
    across them, while the batch's starting state is deterministic."""
    tok = _BATCH.set({"seed": seed})
    try:
        yield
    finally:
        _BATCH.reset(tok)


def get_batch_streams(make):
    """Return this batch scope's stream object, creating it with
    ``make(seed)`` on first use within the scope; None outside any
    batch scope (callers fall back to their own persistent streams)."""
    st = _BATCH.get()
    if st is None:
        return None
    if "streams" not in st:
        st["streams"] = make(st["seed"])
    return st["streams"]
