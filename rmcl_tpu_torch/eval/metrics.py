"""Metric accumulators (reference vilt/gadgets/my_metrics.py) and the
per-split metric bag (reference vilt/modules/vilt_utils.py set_metrics /
epoch_wrapup): the port's own copy of the JAX package's ``eval/metrics.py``.

The reference uses PL `Metric` objects with dist_reduce_fx="sum"; here
accumulators are plain python floats fed with numpy scalars on host, summed
across processes (``parallel/comm.py:all_gather``) before ``epoch_wrapup``
computes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from rmcl_tpu_torch.parallel import comm


class Accuracy:
    """Argmax accuracy ignoring target==-100 (reference my_metrics.py:5-28)."""

    def __init__(self):
        self.correct = 0.0
        self.total = 0.0

    def update(self, logits, target):
        logits = np.asarray(logits)
        target = np.asarray(target)
        if logits.ndim > target.ndim:
            preds = logits.argmax(axis=-1)
        else:
            preds = logits
        keep = target != -100
        self.correct += float((preds[keep] == target[keep]).sum())
        self.total += float(keep.sum())

    def compute(self) -> float:
        return self.correct / max(self.total, 1.0)

    def reset(self):
        self.correct = self.total = 0.0


class Scalar:
    """Running mean (reference my_metrics.py:47-62)."""

    def __init__(self):
        self.value = 0.0
        self.n = 0.0

    def update(self, v, weight: float = 1.0):
        self.value += float(np.asarray(v)) * weight
        self.n += weight

    def compute(self) -> float:
        return self.value / max(self.n, 1.0)

    def reset(self):
        self.value = self.n = 0.0


class VQAScore:
    """Soft VQA score: one-hot(pred) . target (reference my_metrics.py:65-85)."""

    def __init__(self):
        self.score = 0.0
        self.total = 0.0

    def update(self, logits, targets):
        logits = np.asarray(logits)
        targets = np.asarray(targets)
        preds = logits.argmax(axis=-1)
        self.score += float(targets[np.arange(len(preds)), preds].sum())
        self.total += float(len(preds))

    def compute(self) -> float:
        return self.score / max(self.total, 1.0)

    def reset(self):
        self.score = self.total = 0.0


def change_rate(pred_attacked, pred_clean) -> float:
    """Prediction-flip rate under attack (reference my_metrics.py:30-45)."""
    a = np.asarray(pred_attacked)
    c = np.asarray(pred_clean)
    return float((a != c).mean()) if a.size else 0.0


# --------------------------------------------------------------- the bag
# per-loss metric construction (reference vilt_utils.py:13-84)
_ACC_LOSSES = ("itm", "mlm", "mpp", "nlvr2", "irtr")


class MetricBag:
    """Holds split×loss metrics, updates from a step's ret dict, and
    assembles `the_metric` at epoch end (reference epoch_wrapup,
    vilt_utils.py:86-313)."""

    def __init__(self, loss_names: Dict[str, float]):
        self.loss_names = loss_names
        self.metrics: Dict[str, object] = {}
        for k, v in loss_names.items():
            if v < 1:
                continue
            self.metrics[f"{k}_loss"] = Scalar()
            if k == "vqa" or k == "vqa_attacked":
                self.metrics["vqa_score"] = VQAScore()
            if k in _ACC_LOSSES or k in ("nlvr2_attacked", "irtr_attacked"):
                self.metrics[f"{k}_accuracy"] = Accuracy()
        self.extra: Dict[str, Scalar] = {}

    # -------------------------------------------------------------- update
    def update(self, ret: Dict[str, np.ndarray], valid=None):
        """Accepts both eval-step rets (with logits) and train-step rets
        (scalars only — the train step returns no arrays; objectives
        emit in-graph `*_step_accuracy` scalars for those).

        `valid` (bool [B]) masks wrap-around padding rows the static-shape
        val/test loader appends (data/loader.py): per-sample metrics drop
        masked rows.  Loss scalars: objectives that emit a per-sample
        decomposition (`{key}_ps` sums + optional `{key}_wt` weights —
        PARITY #10) recombine EXACTLY over the valid rows (identical to
        an exact-size final batch, i.e. torch's ragged last batch,
        reference base_dataset.py:184-206); batch-coupled losses without
        one (BarlowTwins correlation) fall back to weighting the batch
        mean by the valid fraction."""
        ln = self.loss_names
        w = 1.0
        if valid is not None:
            valid = np.asarray(valid, bool)
            if valid.all():
                valid = None
            else:
                w = float(valid.mean())

        def rows(key):
            a = np.asarray(ret[key])
            if valid is not None and a.ndim >= 1 \
                    and a.shape[0] == valid.shape[0]:
                return a[valid]
            return a

        def update_loss(metric, key):
            ps = ret.get(key + "_ps")
            if valid is not None and ps is not None \
                    and np.asarray(ps).shape[:1] == valid.shape:
                psv = np.asarray(ps, np.float64)[valid]
                wt = ret.get(key + "_wt")
                denom = (float(np.asarray(wt, np.float64)[valid].sum())
                         if wt is not None else float(valid.sum()))
                # the exact-size loader's final batch updates with
                # weight 1 (one batch-mean per update, reference PL
                # Scalar semantics) — so does the masked recombination
                metric.update(psv.sum() / max(denom, 1.0), weight=1.0)
            else:
                metric.update(ret[key], weight=w)

        # losses accumulate from their scalar whenever present
        for key, metric in self.metrics.items():
            if key.endswith("_loss") and key in ret:
                update_loss(metric, key)
        if ln.get("mlm", 0) >= 1 and "mlm_logits" in ret:
            self.metrics["mlm_accuracy"].update(rows("mlm_logits"),
                                                rows("mlm_labels"))
        if ln.get("mpp", 0) >= 1 and "mpp_logits" in ret:
            self.metrics["mpp_accuracy"].update(
                rows("mpp_logits").reshape(-1, 256),
                rows("mpp_labels").reshape(-1))
        if ln.get("itm", 0) >= 1 and "itm_logits" in ret:
            self.metrics["itm_accuracy"].update(rows("itm_logits"),
                                                rows("itm_labels"))
        if ln.get("vqa", 0) >= 1 and "vqa_logits" in ret:
            self.metrics["vqa_score"].update(rows("vqa_logits"),
                                             rows("vqa_targets"))
        elif ln.get("vqa_attacked", 0) >= 1 \
                and "vqa_attacked_logits" in ret:
            # attacked-only config: vqa_score measures the attacked
            # accuracy (reference metric naming, vilt_utils.py:99-115)
            self.metrics["vqa_score"].update(rows("vqa_attacked_logits"),
                                             rows("vqa_targets"))
        if ln.get("nlvr2", 0) >= 1 and "nlvr2_logits" in ret:
            self.metrics["nlvr2_accuracy"].update(rows("nlvr2_logits"),
                                                  rows("nlvr2_labels"))
        if ln.get("nlvr2_attacked", 0) >= 1 and "nlvr2_attacked_logits" in ret:
            self.metrics["nlvr2_attacked_accuracy"].update(
                rows("nlvr2_attacked_logits"), rows("nlvr2_labels"))
        if ln.get("irtr", 0) >= 1 and "irtr_logits" in ret:
            self.metrics["irtr_accuracy"].update(rows("irtr_logits"),
                                                 rows("irtr_labels"))
        if ln.get("irtr_attacked", 0) >= 1 and "irtr_attacked_logits" in ret:
            self.metrics["irtr_attacked_accuracy"].update(
                rows("irtr_attacked_logits"), rows("irtr_labels"))
        # free-form scalar telemetry (pgd_delta, success rates,
        # in-graph *_step_accuracy, distances).  Check ndim BEFORE
        # materialising: np.asarray on a device array forces a second
        # full host transfer of every large logits tensor per step.
        for k, v in ret.items():
            if k in self.metrics:
                continue
            if (isinstance(v, (int, float))
                    or getattr(v, "ndim", None) == 0):
                if k.endswith("_loss") and (k + "_ps") in ret:
                    update_loss(self.extra.setdefault(k, Scalar()), k)
                else:
                    self.extra.setdefault(k, Scalar()).update(np.asarray(v))

    # ------------------------------------------------ cross-host reduce
    def _cross_host_sync(self):
        """Sum every accumulator's fields across processes (the reference's
        PL Metric dist_reduce_fx="sum", vilt/gadgets/my_metrics.py; the JAX
        package's ``_cross_host_sync``).  Right for both update styles:
        per-sample updates of each process's rows sum to the global totals,
        and the same scalar on every process scales numerator and
        denominator alike, leaving the mean as it is.  A key some process
        lacks is summed over those that have it."""
        if comm.get_world_size() == 1:
            return
        mine = {k: {f: float(x) for f, x in vars(m).items()}
                for k, m in {**self.metrics, **self.extra}.items()}
        everyone = comm.all_gather(mine)
        for k, m in {**self.metrics, **self.extra}.items():
            for f in vars(m):
                setattr(m, f, sum(host[k][f] for host in everyone if k in host))

    # ------------------------------------------------------------- wrapup
    def epoch_wrapup(self, split: str = "val",
                     recall: Optional[Tuple[float, ...]] = None
                     ) -> Dict[str, float]:
        """Compute all metrics + `the_metric` model-selection scalar
        (reference vilt_utils.py:86-313) over every process's updates, then
        reset."""
        self._cross_host_sync()
        out = {k: m.compute() for k, m in self.metrics.items()}
        out.update({k: m.compute() for k, m in self.extra.items()})
        the_metric = 0.0
        ln = self.loss_names
        if recall is not None:
            # ir_r1 + tr_r1 dominate model selection (ref :90-110)
            out["ir_r1"], out["ir_r5"], out["ir_r10"], \
                out["tr_r1"], out["tr_r5"], out["tr_r10"] = recall
            the_metric += recall[0] + recall[3]
        if ln.get("vqa", 0) >= 1 or ln.get("vqa_attacked", 0) >= 1:
            the_metric += out.get("vqa_score", 0.0)
        if ln.get("nlvr2", 0) >= 1:
            the_metric += out.get("nlvr2_accuracy", 0.0)
        if ln.get("nlvr2_attacked", 0) >= 1:
            the_metric += out.get("nlvr2_attacked_accuracy", 0.0)
        for k in ("mlm", "itm", "mpp", "irtr"):
            if ln.get(k, 0) >= 1:
                the_metric += out.get(f"{k}_accuracy", 0.0)
        for k in ("moco", "barlowtwins"):
            if ln.get(k, 0) >= 1:
                the_metric += -out.get(f"{k}_loss", 0.0)
        out[f"{split}/the_metric"] = the_metric
        for m in list(self.metrics.values()) + list(self.extra.values()):
            m.reset()
        return out
