"""Multitask datamodule: datasets x splits -> sharded loaders (port of the JAX
package's ``data/datamodule.py``).

Behavioural spec: reference vilt/datamodules/{datamodule_base.py,
multitask_datamodule.py, vqav2_datamodule.py}.  One class covers what the
reference splits over BaseDataModule + 7 subclasses + MTDataModule:
per-dataset construction is table-driven (DATASETS registry), the
answer-vocab build for VQA lives here (reference vqav2_datamodule.py:18-36),
and loaders shard per process: the process index and count are arguments,
the rank and the world size under several processes (``train/loop.py``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

from rmcl_tpu_torch.data.arrow_dataset import collate as base_collate
from rmcl_tpu_torch.data.datasets import (
    DATASETS, VQAv2Dataset, nlvr2_collate_extras, vqa_collate_extras)
from rmcl_tpu_torch.data.loader import ConcatDataset, DataLoader
from rmcl_tpu_torch.data.mlm import MLMCollator
from rmcl_tpu_torch.data.tokenizer import get_tokenizer


class MultitaskDataModule:
    def __init__(self, cfg, vocab_path: Optional[str] = None,
                 process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.tokenizer = get_tokenizer(cfg.tokenizer, vocab_path)
        self.mlm_collator = MLMCollator(
            self.tokenizer, mlm_prob=cfg.mlm_prob,
            whole_word=cfg.whole_word_masking, seed=cfg.seed)
        self.datasets: Dict[str, Dict[str, Any]] = {}
        self.answer2id: Dict[str, int] = {}
        self.id2answer: Dict[int, str] = {}

    # ------------------------------------------------------------ build
    def _make_dataset(self, name: str, split: str, no_false: bool = False):
        cfg = self.cfg
        cls = DATASETS[name]
        keys = (cfg.train_transform_keys if split == "train"
                else cfg.val_transform_keys)
        # Skip false draws no active loss consumes: only ITM reads
        # false_image_0 and only IRTR reads false_text_i, yet the reference
        # decodes them whenever draw_false_* > 0 (task_moco inherits
        # draw_false_image=1, reference config.py:39).  Disable with
        # skip_unused_false_draws=False.
        dfi, dft = cfg.draw_false_image, cfg.draw_false_text
        if cfg.skip_unused_false_draws:
            ln = dict(cfg.loss_names)
            if ln.get("itm", 0) < 1:
                dfi = 0
            if ln.get("irtr", 0) < 1 and ln.get("irtr_attacked", 0) < 1:
                dft = 0
        kw = dict(
            data_dir=cfg.data_root,
            transform_keys=list(keys),
            image_size=cfg.image_size,
            max_text_len=cfg.max_text_len,
            draw_false_image=0 if no_false else dfi,
            draw_false_text=0 if no_false else dft,
            image_only=cfg.image_only,
            bucket_hw=cfg.image_bucket_hw,
            tokenizer=self.tokenizer,
            split=split,
            image_dtype=cfg.image_dtype,
        )
        return cls(**kw)

    def setup(self):
        for split in ("train", "val", "test"):
            parts = [self._make_dataset(n, split) for n in self.cfg.datasets]
            self.datasets[split] = {
                "concat": ConcatDataset(parts), "parts": parts}
        if "vqa" in self.cfg.datasets:
            self._build_answer_vocab()

    def make_no_false_dset(self, name: str, split: str = "val"):
        """Recall-eval dataset without negatives (reference
        datamodule_base.py:112-123)."""
        return self._make_dataset(name, split, no_false=True)

    def _build_answer_vocab(self):
        """reference vqav2_datamodule.py:18-36"""
        answers: List[str] = []
        labels: List[int] = []
        for split in ("train", "val"):
            for part in self.datasets[split]["parts"]:
                if not isinstance(part, VQAv2Dataset) or part.table is None:
                    continue
                a = part.table["answers"].to_pandas().tolist()
                l = part.table["answer_labels"].to_pandas().tolist()  # noqa: E741
                answers += [x for xx in a if xx is not None
                            for x1 in xx for x in x1]
                labels += [x for xx in l if xx is not None
                           for x1 in xx for x in x1]
        self.answer2id = dict(zip(answers, labels))
        self.id2answer = defaultdict(lambda: "unknown")
        for k, v in sorted(self.answer2id.items(), key=lambda x: x[1]):
            self.id2answer[v] = k
        self.num_class = (max(self.answer2id.values()) + 1
                          if self.answer2id else self.cfg.vqav2_label_size)

    # ---------------------------------------------------------- collate
    def collate(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = base_collate(batch, self.mlm_collator,
                           bucket_hw=self.cfg.image_bucket_hw,
                           image_layout=self.cfg.image_layout,
                           patch_size=self.cfg.patch_size)
        if batch and "vqa_labels" in batch[0]:
            vqa_collate_extras(batch, out, self.cfg.vqav2_label_size)
        if batch and "table_name" in batch[0]:
            nlvr2_collate_extras(batch, out)
        return out

    # ---------------------------------------------------------- loaders
    def _loader(self, split: str, batch_size: int, shuffle: bool,
                drop_last: bool) -> DataLoader:
        # role salts the per-batch collate RNG so train/val/test loaders
        # sharing cfg.seed never replay each other's MLM mask streams
        # (data/rng.py batch_seed)
        return DataLoader(
            self.datasets[split]["concat"], batch_size=batch_size,
            collate_fn=self.collate, shuffle=shuffle, seed=self.cfg.seed,
            drop_last=drop_last, num_workers=self.cfg.num_workers,
            process_index=self.process_index,
            process_count=self.process_count,
            num_worker_procs=self.cfg.num_worker_procs,
            role=("train", "val", "test").index(split))

    def train_loader(self, per_host_batch: int) -> DataLoader:
        return self._loader("train", per_host_batch, True, True)

    def val_loader(self, per_host_batch: int) -> DataLoader:
        return self._loader("val", per_host_batch, False, False)

    def test_loader(self, per_host_batch: int) -> DataLoader:
        return self._loader("test", per_host_batch, False, False)
