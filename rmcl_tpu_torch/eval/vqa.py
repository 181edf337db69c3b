"""VQA test-submission writing and the official accuracy (port of the JAX
package's ``eval/vqa.py``; numpy and the standard library only).

Submission: reference objectives.py vqa_test_step:1519-1530 /
vqa_test_wrapup:1537-1565, the (question_id, answer) list written as
``vqa_submit_{name}.json``; over several processes every rank's part is
gathered and rank 0 alone writes the merged file.

Accuracy: reference vilt/gadgets/{vqa.py,vqa_eval.py,vqa_acc.py}, the
official VQAv2 evaluation (10 annotators, acc = min(#matching / 3, 1)
averaged over the 10 leave-one-out subsets, with answer normalization).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from rmcl_tpu_torch.data.vqa_glossary import process_digit_article, process_punctuation


# ------------------------------------------------------------- submission
class VQASubmissionWriter:
    """Accumulates (qid, answer) across eval steps and writes the submission
    json on ``finalize``."""

    def __init__(self, id2answer: Dict[int, str], out_dir: str = "result",
                 model_name: str = "vqa"):
        self.id2answer = id2answer
        self.out_dir = out_dir
        self.model_name = model_name
        self.qids: List[int] = []
        self.preds: List[int] = []

    def update(self, qids: Sequence[int], vqa_logits: np.ndarray):
        preds = np.asarray(vqa_logits).argmax(axis=-1)
        self.qids += [int(q) for q in qids]
        self.preds += [int(p) for p in preds]

    def finalize(self, process_index: int = 0, process_count: int = 1,
                 gather=None) -> Optional[str]:
        """Writes the file and returns its path.  With ``process_count`` > 1,
        ``gather(rets)`` (``parallel/comm.py:all_gather``) returns every
        rank's list in rank order; rank 0 writes them merged and returns the
        path, the other ranks return None.  The merge interleaves the parts
        (rank 0's first answer, rank 1's first, ...): the loader gives rank r
        the samples r, r + W, ... of the one-process order
        (``data/loader.py``), so the merged file is the one-process file."""
        rets = [{"question_id": q, "answer": self.id2answer[p]}
                for q, p in zip(self.qids, self.preds)]
        if process_count > 1:
            if gather is None:
                raise ValueError("finalize over several processes needs gather")
            parts = gather(rets)
            if process_index != 0:
                return None
            rets = [part[i] for i in range(max(map(len, parts), default=0))
                    for part in parts if i < len(part)]
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"vqa_submit_{self.model_name}.json")
        with open(path, "w") as fp:
            json.dump(rets, fp, indent=4)
        return path


# ------------------------------------------------------- official accuracy
def _norm(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def vqa_accuracy(predictions: Dict[int, str],
                 annotations: List[Dict[str, Any]],
                 questions: Optional[Dict[int, str]] = None) -> Dict[str, float]:
    """Official VQA accuracy (reference vilt/gadgets/vqa_eval.py).

    predictions: {question_id: answer string}; annotations: the official
    annotation dicts (question_id, answers [{answer}], answer_type).
    Returns {"overall", per answer type...} in percent."""
    accs: List[float] = []
    per_type: Dict[str, List[float]] = {}
    for ann in annotations:
        qid = ann["question_id"]
        if qid not in predictions:
            continue
        res = _norm(predictions[qid])
        gts = [_norm(a["answer"]) for a in ann["answers"]]
        # averaged over the leave-one-out annotator subsets
        gt_accs = []
        for i in range(len(gts)):
            other = gts[:i] + gts[i + 1:]
            matching = sum(1 for g in other if g == res)
            gt_accs.append(min(1.0, matching / 3.0))
        acc = float(np.mean(gt_accs))
        accs.append(acc)
        per_type.setdefault(ann.get("answer_type", "other"), []).append(acc)
    out = {"overall": round(100.0 * float(np.mean(accs)), 2) if accs else 0.0}
    for t, v in per_type.items():
        out[t] = round(100.0 * float(np.mean(v)), 2)
    return out


def evaluate_submission(submission_path: str, annotation_path: str,
                        question_path: Optional[str] = None) -> Dict[str, float]:
    """CLI-style scorer (reference vilt/gadgets/vqa_acc.py)."""
    with open(submission_path) as fp:
        preds = {r["question_id"]: r["answer"] for r in json.load(fp)}
    with open(annotation_path) as fp:
        anns = json.load(fp)["annotations"]
    return vqa_accuracy(preds, anns)
