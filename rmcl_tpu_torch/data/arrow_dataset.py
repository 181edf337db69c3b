"""Arrow-backed dataset core + static-shape collate (port of the JAX
package's ``data/arrow_dataset.py``).

Behavioural spec: reference vilt/datasets/base_dataset.py.  Same .arrow
files (pyarrow IPC), same index-mapper semantics (flat index -> (image row,
caption idx)), same false-image/false-text negative drawing, same
retry-on-error resampling.

  * collate pads every image into the STATIC bucket canvas (top-left,
    zeros) instead of the per-batch max H x W (reference :184-206), and lays
    it out as patch rows on the host (``data/patch_rows.py``), the layout
    the model reads;
  * text encodings are padded to max_text_len at tokenize time; the MLM
    collator is numpy (``data/mlm.py``);
  * everything returns plain numpy: the Trainer moves the batch to the
    device, so the pipeline is framework-free and thread-friendly.

``pyarrow`` and ``PIL`` are imported by ``ArrowDataset`` only: ``collate``
and the modules built on it import without them.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rmcl_tpu_torch.data.patch_rows import images_to_patch_rows
from rmcl_tpu_torch.data.rng import srandom
from rmcl_tpu_torch.data.transforms import keys_to_transforms, normalize_u8_array


class ArrowDataset:
    def __init__(
        self,
        data_dir: str,
        transform_keys: Sequence[str],
        image_size: int,
        names: Sequence[str],
        text_column_name: str = "",
        remove_duplicate: bool = True,
        max_text_len: int = 40,
        draw_false_image: int = 0,
        draw_false_text: int = 0,
        image_only: bool = False,
        max_num: int = -1,
        bucket_hw: Optional[Tuple[int, int]] = None,
        tokenizer=None,
        image_dtype: str = "float32",
    ):
        import pyarrow as pa
        assert len(transform_keys) >= 1
        self.transforms = keys_to_transforms(transform_keys, image_size,
                                             bucket_hw, image_dtype)
        self.image_dtype = image_dtype
        self.text_column_name = text_column_name
        self.names = list(names)
        self.max_text_len = max_text_len
        self.draw_false_image = draw_false_image
        self.draw_false_text = draw_false_text
        self.image_only = image_only
        self.data_dir = data_dir
        self.bucket_hw = bucket_hw
        self.tokenizer = tokenizer

        tables = []
        kept_names = []
        for name in names:
            path = f"{data_dir}/{name}.arrow"
            if os.path.isfile(path):
                tables.append(
                    pa.ipc.RecordBatchFileReader(
                        pa.memory_map(path, "r")).read_all())
                kept_names.append(name)

        self.table_names: List[str] = []
        for name, t in zip(kept_names, tables):
            self.table_names += [name] * len(t)

        if tables:
            try:
                self.table = pa.concat_tables(
                    tables, promote_options="default")
            except TypeError:  # older pyarrow
                self.table = pa.concat_tables(tables, promote=True)
        else:
            self.table = None

        if text_column_name and self.table is not None:
            texts = self.table[text_column_name].to_pandas().tolist()
            self.all_texts = ([list(set(t)) for t in texts]
                              if remove_duplicate else texts)
        else:
            self.all_texts = []

        # flat idx -> (image row, caption idx) (reference :70-84)
        self.index_mapper: Dict[int, Tuple[int, Optional[int]]] = {}
        if text_column_name and not image_only:
            j = 0
            lim = len(self.all_texts) if max_num == -1 else max_num
            for i, texts in enumerate(self.all_texts[:lim]):
                for _j in range(len(texts)):
                    self.index_mapper[j] = (i, _j)
                    j += 1
        elif self.table is not None:
            lim = len(self.table) if max_num == -1 else max_num
            for i in range(min(len(self.table), lim)):
                self.index_mapper[i] = (i, None)

    @property
    def corpus(self) -> List[str]:
        return [t for texts in self.all_texts for t in texts]

    def __len__(self) -> int:
        return len(self.index_mapper)

    # ------------------------------------------------------------ images
    def get_raw_image(self, index: int, image_key: str = "image"):
        from PIL import Image
        row, _ = self.index_mapper[index]
        data = io.BytesIO(self.table[image_key][row].as_py())
        data.seek(0)
        return Image.open(data).convert("RGB")

    def get_image(self, index: int, image_key: str = "image") -> Dict[str, Any]:
        image = self.get_raw_image(index, image_key=image_key)
        return {
            "image": [tr(image) for tr in self.transforms],
            "img_index": self.index_mapper[index][0],
            "cap_index": self.index_mapper[index][1],
            "raw_index": index,
        }

    def get_false_image(self, rep: int, image_key: str = "image"):
        idx = srandom.randint(0, len(self.index_mapper) - 1)
        image = self.get_raw_image(idx, image_key=image_key)
        return {f"false_image_{rep}": [tr(image) for tr in self.transforms]}

    # ------------------------------------------------------------- text
    def _encode(self, text: str) -> Dict[str, Any]:
        return self.tokenizer(
            text, padding="max_length", truncation=True,
            max_length=self.max_text_len, return_special_tokens_mask=True)

    def get_text(self, raw_index: int) -> Dict[str, Any]:
        row, cap = self.index_mapper[raw_index]
        text = self.all_texts[row][cap]
        return {
            "text": (text, self._encode(text)),
            "img_index": row,
            "cap_index": cap,
            "raw_index": raw_index,
        }

    def get_false_text(self, rep: int):
        idx = srandom.randint(0, len(self.index_mapper) - 1)
        row, cap = self.index_mapper[idx]
        text = self.all_texts[row][cap]
        return {f"false_text_{rep}": (text, self._encode(text))}

    # ------------------------------------------------------------- suite
    def get_suite(self, index: int) -> Dict[str, Any]:
        result = None
        while result is None:
            try:
                ret: Dict[str, Any] = {}
                ret.update(self.get_image(index))
                if not self.image_only:
                    txt = self.get_text(index)
                    ret["replica"] = bool(txt["cap_index"] and txt["cap_index"] > 0)
                    ret.update(txt)
                for i in range(self.draw_false_image):
                    ret.update(self.get_false_image(i))
                for i in range(self.draw_false_text):
                    ret.update(self.get_false_text(i))
                result = True
            except Exception as e:  # retry with a random index (ref :146-165)
                print(f"Error while read file idx {index} in "
                      f"{self.names[0] if self.names else '?'} -> {e}")
                index = srandom.randint(0, len(self.index_mapper) - 1)
        return ret

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.get_suite(index)

    # ------------------------------------------------------------ collate
    def collate(self, batch: List[Dict[str, Any]], mlm_collator
                ) -> Dict[str, Any]:
        return collate(batch, mlm_collator, bucket_hw=self.bucket_hw)


def _canvas_shape(imgs: Sequence[np.ndarray],
                  bucket_hw: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    if bucket_hw is not None:
        return bucket_hw
    return (max(i.shape[0] for i in imgs), max(i.shape[1] for i in imgs))


def collate(batch: List[Dict[str, Any]], mlm_collator,
            bucket_hw: Optional[Tuple[int, int]] = None,
            image_layout: str = "patch",
            patch_size: int = 32) -> Dict[str, Any]:
    """Batch dict with every image key padded to the static canvas, and text
    keys expanded to *_ids / *_labels / *_ids_mlm / *_labels_mlm / *_masks
    (reference base_dataset.py:167-245).  ``image_layout="patch"`` lays the
    canvas out as patch rows (B, gh*gw, P*P*3) on the host; ``"hwc"`` keeps
    the (B, H, W, 3) canvas, which the model turns into patch rows on entry
    (``models/vit.py:as_patch_rows``)."""
    if image_layout not in ("patch", "hwc"):
        raise ValueError(f"image_layout must be 'patch' or 'hwc', got {image_layout!r}")
    B = len(batch)
    keys = {k for b in batch for k in b}
    out: Dict[str, Any] = {
        k: [b.get(k) for b in batch] for k in keys}

    img_keys = [k for k in out if "image" in k]
    for k in img_keys:
        views = out[k]            # per-sample list of per-transform arrays
        n_views = len(views[0])
        stacked = []
        for vi in range(n_views):
            imgs = [v[vi] for v in views]
            if n_views > 1 and imgs and imgs[0].dtype == np.uint8:
                # multi-view batches keep the f32 wire format (the u8
                # hw-metadata contract is single-view); same normalise math
                imgs = [normalize_u8_array(im) for im in imgs]
            H, W = _canvas_shape(imgs, bucket_hw)
            if image_layout == "patch":
                stacked.append(images_to_patch_rows(imgs, H, W, patch_size))
            else:
                canvas = np.zeros(
                    (B, H, W, 3),
                    np.uint8 if imgs[0].dtype == np.uint8 else np.float32)
                for bi, im in enumerate(imgs):
                    h, w = im.shape[:2]
                    canvas[bi, :min(h, H), :min(w, W)] = im[:H, :W]
                stacked.append(canvas)
            if n_views == 1 and stacked[0].dtype == np.uint8:
                # u8 wire format: per-sample valid (h, w) — the device
                # rebuilds the exact zero-padding rect on entry
                out[f"{k}_hw"] = np.asarray(
                    [[min(im.shape[0], H), min(im.shape[1], W)]
                     for im in imgs], np.int32)
        # single-transform fast path: plain array (model API takes one view)
        out[k] = stacked[0] if n_views == 1 else stacked

    txt_keys = [k for k in out if "text" in k]
    for k in txt_keys:
        pairs = out[k]
        texts = [p[0] for p in pairs]
        encs = [p[1] for p in pairs]
        ids = np.asarray([e["input_ids"] for e in encs], np.int32)
        attn = np.asarray([e["attention_mask"] for e in encs], np.int32)
        special = np.asarray([e["special_tokens_mask"] for e in encs],
                             np.int32)
        mlm_ids, mlm_labels = mlm_collator(ids, special) if mlm_collator \
            else (ids, np.full_like(ids, -100))
        out[k] = texts
        out[f"{k}_ids"] = ids
        out[f"{k}_labels"] = np.full_like(ids, -100)
        out[f"{k}_ids_mlm"] = mlm_ids
        out[f"{k}_labels_mlm"] = mlm_labels
        out[f"{k}_masks"] = attn

    return out
