"""Per-task datasets over the Arrow core (the port's own copy of the JAX
package's ``data/datasets.py``).

Behavioural specs: reference vilt/datasets/*.py (split -> arrow table
names, extra per-sample fields).  Registry mirrors
reference vilt/datamodules/__init__.py:17-25 (`_datamodules`).
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np

from rmcl_tpu_torch.data.arrow_dataset import ArrowDataset
from rmcl_tpu_torch.data.rng import srandom


class CocoCaptionKarpathyDataset(ArrowDataset):
    """reference vilt/datasets/coco_caption_karpathy_dataset.py"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val", "test")
        self.split = split
        if split == "train":
            names = ["coco_caption_karpathy_train",
                     "coco_caption_karpathy_restval"]
        else:  # val and test both use the karpathy test split (ref :12-15)
            names = ["coco_caption_karpathy_test"]
        super().__init__(*args, **kw, names=names, text_column_name="caption")

    def __getitem__(self, index: int) -> Dict[str, Any]:
        suite = self.get_suite(index)
        if "test" in self.split:
            row, _ = self.index_mapper[index]
            iid = self.table["image_id"][row].as_py()
            suite["iid"] = int(iid.split(".")[0].split("_")[-1])
        return suite


class F30KCaptionKarpathyDataset(ArrowDataset):
    """reference vilt/datasets/f30k_caption_karpathy_dataset.py"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val", "test")
        self.split = split
        names = {
            "train": ["f30k_caption_karpathy_train"],
            "val": ["f30k_caption_karpathy_test"],
            "test": ["f30k_caption_karpathy_test"],
        }[split]
        super().__init__(*args, **kw, names=names, text_column_name="caption")


class ConceptualCaptionDataset(ArrowDataset):
    """reference vilt/datasets/conceptual_caption_dataset.py (29 shards)"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val")
        if split == "train":
            names = [f"conceptual_caption_train_{i}" for i in range(29)]
        else:
            names = ["conceptual_caption_val_0"]
        super().__init__(*args, **kw, names=names, text_column_name="caption")


class SBUCaptionDataset(ArrowDataset):
    """reference vilt/datasets/sbu_caption_dataset.py (9 shards)"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val")
        names = [f"sbu_{i}" for i in range(9)] if split == "train" else []
        super().__init__(*args, **kw, names=names, text_column_name="caption")


class VisualGenomeCaptionDataset(ArrowDataset):
    """reference vilt/datasets/vg_caption_dataset.py"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val")
        names = ["vg"] if split == "train" else []
        super().__init__(*args, **kw, names=names, text_column_name="caption")


class VQAv2Dataset(ArrowDataset):
    """reference vilt/datasets/vqav2_dataset.py"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val", "test")
        self.split = split
        names = {
            "train": ["vqav2_train", "vqav2_trainable_val"],
            "val": ["vqav2_val"],
            "test": ["vqav2_val"],
        }[split]
        super().__init__(*args, **kw, names=names,
                         text_column_name="questions",
                         remove_duplicate=False)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        image = self.get_image(index)["image"]
        text = self.get_text(index)["text"]
        row, qi = self.index_mapper[index]
        qid = self.table["question_id"][row][qi].as_py()
        if self.split != "test":
            answers = self.table["answers"][row][qi].as_py()
            labels = self.table["answer_labels"][row][qi].as_py()
            scores = self.table["answer_scores"][row][qi].as_py()
        else:
            answers, labels, scores = [], [], []
        return {
            "image": image,
            "text": text,
            "vqa_answer": answers,
            "vqa_labels": labels,
            "vqa_scores": scores,
            "qid": qid,
        }


class NLVR2Dataset(ArrowDataset):
    """reference vilt/datasets/nlvr2_dataset.py"""

    def __init__(self, *args, split: str = "", **kw):
        assert split in ("train", "val", "test")
        self.split = split
        names = (["nlvr2_train"] if split == "train"
                 else ["nlvr2_dev", "nlvr2_test1"])
        super().__init__(*args, **kw, names=names,
                         text_column_name="questions",
                         remove_duplicate=False)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        result = None
        while result is None:
            try:
                img0 = self.get_image(index, image_key="image_0")["image"]
                img1 = self.get_image(index, image_key="image_1")["image"]
                text = self.get_text(index)["text"]
                result = True
            except Exception:
                print(f"error while read file idx {index}", file=sys.stderr)
                index = srandom.randint(0, len(self.index_mapper) - 1)
        row, qi = self.index_mapper[index]
        answers = self.table["answers"][row][qi].as_py() == "True"
        return {
            "image_0": img0,
            "image_1": img1,
            "text": text,
            "answers": answers,
            "table_name": self.table_names[row],
        }


# registry (reference vilt/datamodules/__init__.py:17-25)
DATASETS = {
    "coco": CocoCaptionKarpathyDataset,
    "f30k": F30KCaptionKarpathyDataset,
    "gcc": ConceptualCaptionDataset,
    "sbu": SBUCaptionDataset,
    "vg": VisualGenomeCaptionDataset,
    "vqa": VQAv2Dataset,
    "nlvr2": NLVR2Dataset,
}


def vqa_collate_extras(batch, out: Dict[str, Any], label_size: int):
    """Dense (B, label_size) soft-target matrix from vqa_labels/scores —
    replaces the reference's per-sample scatter in compute_vqa
    (reference objectives.py:871-878)."""
    B = len(batch)
    targets = np.zeros((B, label_size), np.float32)
    for i, b in enumerate(batch):
        for l, s in zip(b.get("vqa_labels", []), b.get("vqa_scores", [])):
            targets[i, int(l)] = float(s)
    out["vqa_targets"] = targets
    out["vqa_labels"] = [b.get("vqa_labels", []) for b in batch]
    out["vqa_scores"] = [b.get("vqa_scores", []) for b in batch]
    out["qid"] = [b.get("qid") for b in batch]
    return out


def nlvr2_collate_extras(batch, out: Dict[str, Any]):
    out["answers"] = np.asarray([int(b["answers"]) for b in batch], np.int32)
    out["table_name"] = [b["table_name"] for b in batch]
    return out
