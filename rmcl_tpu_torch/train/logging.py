"""Observability: metric logging + profiler tracing (port of the JAX package's
``train/logging.py``).

Reference (SURVEY.md §5.1, §5.5): TensorBoardLogger + LearningRateMonitor
+ tqdm.  Here:
  * MetricLogger — JSONL metrics file (always) + TensorBoard events when
    ``torch.utils.tensorboard`` imports; rank-0 only.  Values are host
    numbers: the Trainer reads the device once per log interval.
  * profile_steps — a ``torch.profiler`` trace of a step window, written as
    a Chrome trace (``trace.json``) into the log directory.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict

import numpy as np


class MetricLogger:
    def __init__(self, logdir: str, enabled: bool = True):
        self.enabled = enabled
        self.logdir = logdir
        self._tb = None
        self._fp = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        self._fp = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except Exception:
            self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = ""):
        if not self.enabled:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[prefix + k] = float(np.asarray(v))
            except (TypeError, ValueError):
                continue
        rec = {"step": int(step), "time": time.time(), **clean}
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        if self._fp:
            self._fp.close()
        if self._tb is not None:
            self._tb.close()


@contextmanager
def profile_steps(logdir: str, enabled: bool = True):
    """``torch.profiler`` window around a few train steps (CPU and, when
    there is one, the CUDA device); the trace goes to
    ``<logdir>/trace.json`` (chrome://tracing or Perfetto) and the profile
    object is yielded for ``key_averages()``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
