"""Raw-dataset -> Arrow converters: the port's own copy of the JAX package's
``data/writers.py`` (``cli.run prepare``).

Behavioural spec: reference vilt/utils/write_{coco_karpathy,f30k_karpathy,
conceptual_caption,sbu,vg,nlvr2,vqa}.py.  Same output schemas and file
names, so tables written here are interchangeable with reference-written
ones (and vice versa: the loaders read either), and byte for byte the JAX
package's under the same global ``random`` state (the writers shuffle the
image paths with it, as the reference does).

All writers share ``_write_table`` (pandas-free: plain pyarrow arrays).
pyarrow is imported inside the functions, so this module imports without
it.
"""

from __future__ import annotations

import json
import os
import random
from collections import Counter, defaultdict
from glob import glob
from typing import Any, Dict, List, Sequence

from rmcl_tpu_torch.data.vqa_glossary import normalize_word


def _write_table(rows: Dict[str, List[Any]], path: str):
    import pyarrow as pa
    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = pa.table(rows)
    with pa.OSFile(path, "wb") as sink:
        with pa.RecordBatchFileWriter(sink, table.schema) as w:
            w.write_table(table)


def _read_binary(path: str) -> bytes:
    with open(path, "rb") as fp:
        return fp.read()


# --------------------------------------------------------------- karpathy
def _make_karpathy(root: str, dataset_root: str, json_path: str,
                   image_globs: Sequence[str], out_prefix: str,
                   splits: Sequence[str]):
    with open(json_path) as fp:
        captions = json.load(fp)["images"]
    iid2captions: Dict[str, List[str]] = defaultdict(list)
    iid2split: Dict[str, str] = {}
    for cap in captions:
        iid2split[cap["filename"]] = cap["split"]
        for c in cap["sentences"]:
            iid2captions[cap["filename"]].append(c["raw"])

    paths: List[str] = []
    for g in image_globs:
        paths += glob(g)
    random.shuffle(paths)
    paths = [p for p in paths if os.path.basename(p) in iid2captions]

    per_split: Dict[str, Dict[str, List[Any]]] = {
        s: {"image": [], "caption": [], "image_id": [], "split": []}
        for s in splits}
    for p in paths:
        name = os.path.basename(p)
        s = iid2split[name]
        if s not in per_split:
            continue
        per_split[s]["image"].append(_read_binary(p))
        per_split[s]["caption"].append(iid2captions[name])
        per_split[s]["image_id"].append(name)
        per_split[s]["split"].append(s)
    for s, rows in per_split.items():
        _write_table(rows, f"{dataset_root}/{out_prefix}_{s}.arrow")


def make_arrow_coco_karpathy(root: str, dataset_root: str):
    """reference vilt/utils/write_coco_karpathy.py"""
    _make_karpathy(
        root, dataset_root, f"{root}/karpathy/dataset_coco.json",
        [f"{root}/train2014/*.jpg", f"{root}/val2014/*.jpg"],
        "coco_caption_karpathy", ["train", "val", "restval", "test"])


def make_arrow_f30k_karpathy(root: str, dataset_root: str):
    """reference vilt/utils/write_f30k_karpathy.py"""
    _make_karpathy(
        root, dataset_root, f"{root}/karpathy/dataset_flickr30k.json",
        [f"{root}/flickr30k-images/*.jpg"],
        "f30k_caption_karpathy", ["train", "val", "test"])


# --------------------------------------------------------- web-scale sets
def _make_sharded_captions(pairs, dataset_root: str, prefix: str,
                           n_shards: int):
    """pairs: list of (image_path, caption).  Shard round-robin like the
    reference's chunked writers (write_conceptual_caption.py:40-71)."""
    shards = [{"image": [], "caption": []} for _ in range(n_shards)]
    for i, (path, caption) in enumerate(pairs):
        try:
            binary = _read_binary(path)
        except OSError:
            continue
        sh = shards[i % n_shards]
        sh["image"].append(binary)
        sh["caption"].append([caption])
    for i, sh in enumerate(shards):
        _write_table(sh, f"{dataset_root}/{prefix}_{i}.arrow")


def make_arrow_conceptual_caption(root: str, dataset_root: str,
                                  n_shards: int = 29):
    """reference vilt/utils/write_conceptual_caption.py: TSV of
    (caption, url) + downloaded images named by row index."""
    for split, out_prefix, shards in (
            ("train", "conceptual_caption_train", n_shards),
            ("val", "conceptual_caption_val", 1)):
        tsv = f"{root}/{split}.tsv"
        if not os.path.isfile(tsv):
            continue
        pairs = []
        with open(tsv) as fp:
            for i, line in enumerate(fp):
                caption = line.split("\t")[0]
                img = f"{root}/images_{split}/{i}"
                if os.path.isfile(img):
                    pairs.append((img, caption))
        _make_sharded_captions(pairs, dataset_root, out_prefix, shards)


def make_arrow_sbu(root: str, dataset_root: str, n_shards: int = 9):
    """reference vilt/utils/write_sbu.py"""
    caps = f"{root}/annot.json"
    pairs = []
    if os.path.isfile(caps):
        with open(caps) as fp:
            annot = json.load(fp)
        for entry in annot:
            img = f"{root}/images/{entry['filename']}"
            if os.path.isfile(img):
                pairs.append((img, entry["caption"]))
    _make_sharded_captions(pairs, dataset_root, "sbu", n_shards)


def make_arrow_vg(root: str, dataset_root: str):
    """reference vilt/utils/write_vg.py: region descriptions grouped per
    image into one caption list."""
    with open(f"{root}/annotations/region_descriptions.json") as fp:
        annot = json.load(fp)
    iid2captions: Dict[int, List[str]] = defaultdict(list)
    for item in annot:
        for region in item["regions"]:
            iid2captions[region["image_id"]].append(region["phrase"])
    rows = {"image": [], "caption": []}
    for iid, caps in iid2captions.items():
        for sub in ("VG_100K", "VG_100K_2"):
            p = f"{root}/images/{sub}/{iid}.jpg"
            if os.path.isfile(p):
                rows["image"].append(_read_binary(p))
                rows["caption"].append(caps)
                break
    _write_table(rows, f"{dataset_root}/vg.arrow")


# ------------------------------------------------------------------ nlvr2
def make_arrow_nlvr2(root: str, dataset_root: str):
    """reference vilt/utils/write_nlvr2.py: 7 splits, image pairs grouped
    by identifier prefix."""
    def load_jsonl(path):
        with open(path) as fp:
            return [json.loads(l) for l in fp]

    sources = {
        "train": f"{root}/nlvr2/data/train.json",
        "dev": f"{root}/nlvr2/data/dev.json",
        "test1": f"{root}/nlvr2/data/test1.json",
        "balanced_dev": f"{root}/nlvr2/data/balanced/balanced_dev.json",
        "balanced_test1": f"{root}/nlvr2/data/balanced/balanced_test1.json",
        "unbalanced_dev": f"{root}/nlvr2/data/unbalanced/unbalanced_dev.json",
        "unbalanced_test1":
            f"{root}/nlvr2/data/unbalanced/unbalanced_test1.json",
    }
    for split, src in sources.items():
        if not os.path.isfile(src):
            continue
        groups: Dict[str, List[dict]] = defaultdict(list)
        for row in load_jsonl(src):
            iden = "-".join(row["identifier"].split("-")[:-1])
            groups[iden].append(row)
        rows = {"image_0": [], "image_1": [], "questions": [],
                "answers": [], "identifier": []}
        for iden, group in groups.items():
            base_split = iden.split("-")[0]
            if iden.startswith("train"):
                directory = group[0]["directory"]
                path = f"{root}/images/train/{directory}/{iden}"
            else:
                path = f"{root}/{base_split}/{iden}"
            try:
                img0 = _read_binary(f"{path}-img0.png")
                img1 = _read_binary(f"{path}-img1.png")
            except OSError:
                continue
            rows["image_0"].append(img0)
            rows["image_1"].append(img1)
            rows["questions"].append([r["sentence"] for r in group])
            rows["answers"].append([r["label"] for r in group])
            rows["identifier"].append(iden)
        _write_table(rows, f"{dataset_root}/nlvr2_{split}.arrow")


# -------------------------------------------------------------------- vqa
def vqa_score(occurrences: int) -> float:
    """Annotator-agreement soft score (reference write_vqa.py:13-23)."""
    return [0.0, 0.3, 0.6, 0.9][occurrences] if occurrences < 4 else 1.0


def make_arrow_vqa(root: str, dataset_root: str):
    """reference vilt/utils/write_vqa.py: builds the 3129-answer vocab
    (answers appearing >= 9 times), soft scores per question, per-split
    tables + the trainable_val/rest_val split of val."""
    def load(path):
        with open(path) as fp:
            return json.load(fp)

    questions = {
        "train": load(f"{root}/v2_OpenEnded_mscoco_train2014_questions.json")["questions"],
        "val": load(f"{root}/v2_OpenEnded_mscoco_val2014_questions.json")["questions"],
        "test": load(f"{root}/v2_OpenEnded_mscoco_test2015_questions.json")["questions"],
        "test-dev": load(f"{root}/v2_OpenEnded_mscoco_test-dev2015_questions.json")["questions"],
    }
    annotations = {
        "train": load(f"{root}/v2_mscoco_train2014_annotations.json")["annotations"],
        "val": load(f"{root}/v2_mscoco_val2014_annotations.json")["annotations"],
    }

    annot: Dict[str, Dict[int, Dict[int, list]]] = {}
    for split, qs in questions.items():
        d: Dict[int, Dict[int, list]] = defaultdict(dict)
        for q in qs:
            d[q["image_id"]][q["question_id"]] = [q["question"]]
        annot[split] = d

    major = [normalize_word(a["multiple_choice_answer"])
             for split in ("train", "val") for a in annotations[split]]
    counter = {k: v for k, v in Counter(major).items() if v >= 9}
    ans2label = {k: i for i, k in enumerate(counter)}
    label2ans = list(counter)

    for split in ("train", "val"):
        for q in annotations[split]:
            counts: Dict[str, int] = {}
            for a in q["answers"]:
                counts[a["answer"]] = counts.get(a["answer"], 0) + 1
            labels, scores = [], []
            for ans, n in counts.items():
                if ans in ans2label:
                    labels.append(ans2label[ans])
                    scores.append(vqa_score(n))
            annot[split][q["image_id"]][q["question_id"]].append(
                {"labels": labels, "scores": scores})
        # drop questions with no in-vocab answers
        annot[split] = {
            ik: {qk: qv for qk, qv in iv.items() if qv[1]["labels"]}
            for ik, iv in annot[split].items()}
        annot[split] = {ik: iv for ik, iv in annot[split].items() if iv}

    for split in ("train", "val", "test", "test-dev"):
        dirname = {"train": "train2014", "val": "val2014",
                   "test": "test2015", "test-dev": "test2015"}[split]
        paths = [p for p in glob(f"{root}/{dirname}/*.jpg")
                 if int(os.path.basename(p).split("_")[-1][:-4])
                 in annot[split]]
        random.shuffle(paths)
        rows = {"image": [], "questions": [], "answers": [],
                "answer_labels": [], "answer_scores": [], "image_id": [],
                "question_id": [], "split": []}
        has_answers = "test" not in split
        for p in paths:
            iid = int(os.path.basename(p).split("_")[-1][:-4])
            items = list(annot[split][iid].items())
            qids = [qid for qid, _ in items]
            qs = [qa[0] for _, qa in items]
            if has_answers:
                labels = [qa[1]["labels"] for _, qa in items]
                scores = [qa[1]["scores"] for _, qa in items]
                answers = [[label2ans[l] for l in ll] for ll in labels]
            else:
                labels, scores, answers = [], [], []
            rows["image"].append(_read_binary(p))
            rows["questions"].append(qs)
            rows["answers"].append(answers)
            rows["answer_labels"].append(labels)
            rows["answer_scores"].append(scores)
            rows["image_id"].append(iid)
            rows["question_id"].append(qids)
            rows["split"].append(split)
        _write_table(rows, f"{dataset_root}/vqav2_{split}.arrow")

    # split val -> trainable_val (all but last 1000) + rest_val
    import pyarrow as pa
    val = pa.ipc.RecordBatchFileReader(
        pa.memory_map(f"{dataset_root}/vqav2_val.arrow", "r")).read_all()
    n = len(val)
    for name, sl in (("trainable_val", slice(0, max(n - 1000, 0))),
                     ("rest_val", slice(max(n - 1000, 0), n))):
        sub = val.slice(sl.start, sl.stop - sl.start)
        with pa.OSFile(f"{dataset_root}/vqav2_{name}.arrow", "wb") as sink:
            with pa.RecordBatchFileWriter(sink, sub.schema) as w:
                w.write_table(sub)


WRITERS = {
    "coco": make_arrow_coco_karpathy,
    "f30k": make_arrow_f30k_karpathy,
    "gcc": make_arrow_conceptual_caption,
    "sbu": make_arrow_sbu,
    "vg": make_arrow_vg,
    "nlvr2": make_arrow_nlvr2,
    "vqa": make_arrow_vqa,
}
