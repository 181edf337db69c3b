"""The port's remaining pieces against the JAX package on the CPU in fp32:
standalone bidirectional MoCo (objectives/moco_standalone.py), the
cross-entropy NLVR2 greedy attacker (attacks/greedy.py:
GreedyAttackNlvr2CrossEntropy), the HWC canvas (``image_layout="hwc"``:
collate, ViLT.infer and PGD), the arrow writers with ``cli.run prepare``
(data/writers.py) and the native host paths (data/_native).

Sizes: tests/test_extensions.py's (2 layers, C = 32, 2 heads, patch 16, the
(32, 48) bucket, every patch); its fake batches, whose images are HWC
canvases with valid regions that end inside a patch.  Tolerances: losses,
logits, the queue and gradients within 1e-5 x max(1, max|ref|); PGD deltas
within 2.5e-7 (tests/test_torch_downstream.py's); token ids, change counts,
collated batches, writer tables and native outputs equal; the HWC path
equal to the patch-row path exactly (the same numbers, permuted)."""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import pgd as JP
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.data import arrow_dataset as JAD
from rmcl_tpu.data import datasets as JD
from rmcl_tpu.data import writers as JW
from rmcl_tpu.data._native import load_wordpiece as jax_load_wordpiece
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.data.transforms import pixelbert_transform as jax_pixelbert
from rmcl_tpu.models import heads as JH
from rmcl_tpu.models.vilt import ViLTModel, init_vilt
from rmcl_tpu.objectives import moco_standalone as JM
from rmcl_tpu.objectives.losses import l2_normalize as jax_l2_normalize
from rmcl_tpu_torch.attacks import greedy as TG
from rmcl_tpu_torch.attacks import pgd as TP
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax, state_dict_from_jax
from rmcl_tpu_torch.data import _native
from rmcl_tpu_torch.data import arrow_dataset as TAD
from rmcl_tpu_torch.data import datasets as TDS
from rmcl_tpu_torch.data import patch_rows as TR
from rmcl_tpu_torch.data import transforms as TT
from rmcl_tpu_torch.data import writers as TW
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.models.vilt import ViLT, draw_seeds
from rmcl_tpu_torch.models.vit import from_patch_rows, to_patch_rows
from rmcl_tpu_torch.objectives import moco_standalone as TM
from rmcl_tpu_torch.objectives.losses import l2_normalize
from tests.conftest import make_fake_batch
from tests.test_torch_train import _close, _jflat
from tests.test_torch_trainer import CAPTIONS, write_tables
from tests._torch_threads import one_thread  # noqa: F401

DELTA_ATOL = 2.5e-7


def _cfg(losses, **kw):
    """tests/test_extensions.py's configuration."""
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=16,
        image_size=32, image_bucket_hw=(32, 48), max_text_len=10,
        vocab_size=64, loss_names=loss_names(losses), max_image_len=-1,
        use_pallas_attention=False, compute_dtype="float32", drop_rate=0.0)
    base.update(kw)
    return build_config(**base)


def _t(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _init(cfg, seed=0):
    return jax.jit(lambda k: init_vilt(k, cfg))(jax.random.PRNGKey(seed))


def _moved(params, seed, scale=0.1):
    """Every leaf moved off init, so that the class features differ across a
    batch and the attacks' decisions are not ties."""
    r = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * r.randn(*np.shape(a)),
                                              a.dtype), params)


def _port(cfg, params, state, extra=None):
    model = ViLT(cfg)
    if extra is not None:
        extra(model)
    assert model.load_reference_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(params, cfg.num_layers, state).items()}) == []
    return model


# -------------------------------------------------------- standalone MoCo
def test_standalone_moco_matches_jax():
    """compute_standalone_moco, training, with the batch's swapped text and a
    seeded image perturbation from ``pgd_fn`` (handed the momentum text keys
    and the queue, which equal the JAX package's): the three losses, both
    logits, the shared queue and pointer after the two enqueues (pointer +
    2B), the momentum twins, and the gradient of the loss for every
    parameter (the projectors' among them) against jax.grad; every JAX
    gradient the port has no counterpart of is zero.  Then init_standalone_moco's
    queue columns have unit norm, and a queue that is not a multiple of the
    batch raises, as in the JAX package."""
    cfg = _cfg({"moco": 1}, num_negative=16, momentum=0.99, temperature=0.07)
    B = 4
    params, state = _init(cfg)
    params, state = JM.init_standalone_moco(jax.random.PRNGKey(1), cfg, params, state)
    params = _moved(params, 3, 0.02)
    b = make_fake_batch(cfg, batch=B, seed=2)
    b.pop("text_labels")
    swapped = np.roll(b["text_ids"], 1, axis=1) * (b["text_masks"] > 0)
    delta = (np.random.RandomState(4).uniform(-5e-3, 5e-3, b["image"].shape)
             * (b["image"] != 0)).astype(np.float32)
    seen = {}

    def jax_pgd(p, bb, k, q):
        return jnp.asarray(delta)

    def objective(p):
        ret, new_p, new_s = JM.compute_standalone_moco(
            ViLTModel(cfg), p, state, _j(b), rng=jax.random.PRNGKey(5), temperature=0.07,
            momentum=0.99, attacked_text={"text_ids": jnp.asarray(swapped),
                                          "text_masks": jnp.asarray(b["text_masks"])},
            pgd_fn=jax_pgd)
        keys = JM._project(new_p, ViLTModel(cfg).infer_k(new_p, _j(b), deterministic=True),
                           prefix="k_")[0]
        return ret["standalone_moco_loss"], (ret, new_p, new_s, keys)

    (_, (jret, jparams, jstate, jk)), jgrads = jax.jit(
        jax.value_and_grad(objective, has_aux=True))(params)

    model = _port(cfg, params, state,
                  lambda m: TM.init_standalone_moco(cfg, m, torch.Generator().manual_seed(0)))

    def port_pgd(bb, k, q):
        seen["k"], seen["q"] = k.clone(), q.clone()
        return torch.from_numpy(delta)

    seeds = draw_seeds(torch.Generator().manual_seed(0), 1, cfg.num_layers, B, "cpu")[0]
    ret = TM.compute_standalone_moco(
        model, _t(b), seeds=seeds, temperature=0.07, momentum=0.99,
        attacked_text={"text_ids": torch.from_numpy(swapped),
                       "text_masks": torch.from_numpy(b["text_masks"])}, pgd_fn=port_pgd)
    _close("txt keys", seen["k"], jk)
    _close("queue handed to pgd_fn", seen["q"], state["txt_img_queue"])
    assert set(ret) == set(jret)
    for key, ref in jret.items():
        _close(key, ret[key], ref)
    ret["standalone_moco_loss"].backward()
    ours = leaves_to_jax(model)
    assert int(ours["txt_img_queue_ptr"]) == int(jstate["txt_img_queue_ptr"]) == 2 * B
    _close("txt_img_queue", ours["txt_img_queue"], jstate["txt_img_queue"])
    for path, ref in _jflat(jparams).items():
        if path.startswith("k_"):
            _close(path, ours[path], ref)
    grads, jg = leaves_to_jax(model, grads=True), _jflat(jgrads)
    assert {p.split("/")[0] for p in grads} >= {"txt_projector", "img_projector",
                                               "transformer", "text_embeddings"}
    for path, g in jg.items():
        if path in grads:
            _close(f"grad {path}", grads[path], g)
        else:
            assert not np.any(g), path
    fresh = TM.init_standalone_moco(cfg, ViLT(cfg), torch.Generator().manual_seed(1))
    np.testing.assert_allclose(fresh.txt_img_queue.norm(dim=0).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        TM._shared_enqueue(fresh, torch.zeros(3, 128), torch.zeros(3, 128))


# ------------------------------------------------------ the CE attacker
class _Syn:
    """tests/test_extensions.py:88's synonyms, and two more groups."""
    GROUPS = {"dog": ["cat", "hound"], "cat": ["dog"], "grass": ["park", "lawn"],
              "running": ["sitting", "jumping"], "park": ["grass"]}

    def candidates(self, w):
        return self.GROUPS.get(w, [w])

    def __contains__(self, w):
        return w in self.GROUPS


CE_WORDS = ["dog", "cat", "hound", "grass", "park", "running", "sitting", "lawn", "jumping"]
CE_TEXTS = {0: ["dog running grass", "cat sitting park"],
            1: ["the dog in the park", "running cat on grass"],
            2: ["a cat running on the lawn", "dog and hound sitting in grass"]}


@pytest.fixture(scope="module")
def ce(tmp_path_factory):
    """Both tokenizers, the configuration and the JAX package's attacker,
    whose programs compile once for every case (two captions each)."""
    d = tmp_path_factory.mktemp("ce")
    vocab = make_tiny_vocab(str(d / "v.txt"), CE_WORDS)
    jtok = JTokenizer(vocab)
    cfg = _cfg({"nlvr2_attacked": 1}, vocab_size=jtok.vocab_size, n_candidates=2,
               max_loops=2)
    return (jtok, WordPieceTokenizer(vocab), cfg,
            JG.GreedyAttackNlvr2CrossEntropy(cfg, ViLTModel(cfg), jtok, _Syn()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ce_greedy_attack_matches_jax(ce, seed):
    """GreedyAttackNlvr2CrossEntropy on tests/test_extensions.py:88's case
    (seed 0: its weights, captions, images and labels) and on two more
    cases (weights moved off init, other captions and images): token ids,
    masks, the change counts and rate equal the JAX package's; the
    substitutions come from the synonyms.  On seed 0 its loss, cls gradient
    and first-order scores of one candidate set equal the JAX package's."""
    jtok, tok, cfg, jatk = ce
    params, _ = _init(cfg, seed)
    if seed:
        params = _moved(params, seed)
    texts = CE_TEXTS[seed]
    B = len(texts)
    ids, masks = jtok.batch_encode(texts, cfg.max_text_len)
    b0 = make_fake_batch(cfg, batch=B, seed=seed)
    batch = {"text_ids": ids, "text_masks": masks, "image_0": b0["image"],
             "image_1": make_fake_batch(cfg, batch=B, seed=5 + seed)["image"]}
    labels = np.array([0, 1], np.int32)
    ref = jatk.adv_attack_samples(params, dict(batch, text_labels=np.full_like(ids, -100),
                                               answers=labels), (jnp.asarray(labels),))
    model = _port(cfg, params, {})
    atk = TG.GreedyAttackNlvr2CrossEntropy(cfg, model, tok, _Syn())
    ours = atk.adv_attack_samples(_t(batch), (torch.from_numpy(labels),))
    np.testing.assert_array_equal(ours["txt_input_ids"], ref["txt_input_ids"])
    np.testing.assert_array_equal(ours["text_masks"], ref["text_masks"])
    assert ours["changes_verification"] == ref["changes_verification"]
    assert abs(ours["change_rate"] - ref["change_rate"]) < 1e-9
    for new, old in zip(ours["txt_input_ids"], ids):
        new, old = tok.decode(new).split(), tok.decode(old).split()
        assert len(new) == len(old)
        assert all(n == o or n in _Syn().candidates(o) for n, o in zip(new, old))
    if seed:
        return
    cand_ids, cand_masks = jtok.batch_encode([t.replace("dog", "cat") for t in texts
                                              for _ in range(2)], cfg.max_text_len)
    flat = {"text_ids": cand_ids, "text_masks": cand_masks,
            "image_0": np.repeat(batch["image_0"], 2, 0),
            "image_1": np.repeat(batch["image_1"], 2, 0)}
    per, aux, want = jax.jit(lambda p, b, f, lab: (lambda per, aux: (
        per, aux, jatk.score_candidates(p, f, B, 2, None, aux)))(
            *jatk.loss_per_sample(p, b, (lab,))))(params, _j(batch), _j(flat),
                                                  jnp.asarray(labels))
    mats = model.transformer.block_matrices(torch.float32)
    text = ("text_ids", "text_masks")
    with torch.no_grad():
        tper, taux = atk.loss_per_sample(
            dict(atk.image_side(_t(batch)), **_t({k: batch[k] for k in text})),
            (torch.from_numpy(labels),), mats)
        got = atk.score_candidates(dict(atk.image_side(_t(flat)),
                                        **_t({k: flat[k] for k in text})),
                                   B, 2, None, taux, mats)
    _close("per", tper, per)
    _close("grad_cls", taux[1], aux[1])
    _close("scores", got, want)


# ------------------------------------------------------------ HWC canvas
@pytest.fixture(scope="module")
def hwc(tmp_path_factory):
    """The arrow tables, both packages' u8 datasets and their first 4 items."""
    d = tmp_path_factory.mktemp("hwc")
    write_tables(str(d), CAPTIONS, n_train=4, n_test=2)
    vocab = make_tiny_vocab(str(d / "vocab.txt"), ["dog", "running", "park", "the", "red",
                                                   "cat", "sits"])
    kw = dict(data_dir=str(d), transform_keys=["pixelbert"], image_size=32, max_text_len=12,
              bucket_hw=(32, 48), split="train", image_dtype="uint8")
    jds = JD.CocoCaptionKarpathyDataset(tokenizer=JTokenizer(vocab), **kw)
    tds = TDS.CocoCaptionKarpathyDataset(tokenizer=WordPieceTokenizer(vocab), **kw)
    return [jds[i] for i in range(4)], [tds[i] for i in range(4)]


def _same_batch(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


def test_hwc_collate_infer_and_pgd(hwc):
    """collate(image_layout="hwc") equals the JAX package's (the u8 canvas
    and its image_hw); ViLT.infer on it equals the JAX package's and, exactly,
    the port's on the patch-row collate of the same items; make_pgd_moco's
    delta on the fp32 canvas comes back as a canvas, equal to the JAX
    package's and exactly to the patch-row delta laid out as a canvas."""
    jitems, titems = hwc
    canvas = TAD.collate(titems, None, bucket_hw=(32, 48), image_layout="hwc", patch_size=16)
    _same_batch(canvas, JAD.collate(jitems, None, bucket_hw=(32, 48), image_layout="hwc",
                                    patch_size=16))
    rows = TAD.collate(titems, None, bucket_hw=(32, 48), image_layout="patch", patch_size=16)
    assert canvas["image"].shape == (4, 32, 48, 3) and canvas["image"].dtype == np.uint8
    np.testing.assert_array_equal(TR.hwc_to_patch_rows(canvas["image"], 16), rows["image"])
    with pytest.raises(ValueError, match="image_layout"):
        TAD.collate(titems, None, bucket_hw=(32, 48), image_layout="chw")

    cfg = _cfg({"moco": 1}, max_text_len=12, max_image_len=4, num_negative=8,
               image_layout="hwc", image_dtype="uint8")
    params, state = _init(cfg, 1)
    model = _port(cfg, params, state)
    keys = ("image", "image_hw", "text_ids", "text_masks")
    with torch.no_grad():
        a = model.infer(_t({k: canvas[k] for k in keys}))
        p = model.infer(_t({k: rows[k] for k in keys}))
    ref = jax.jit(lambda p, b: {k: v for k, v in ViLTModel(cfg).infer(p, b).items()
                                if k.endswith("_feats")})(params,
                                                          _j({k: canvas[k] for k in keys}))
    for k in ("cls_feats", "text_feats", "image_feats"):
        assert torch.equal(a[k], p[k]), k
        _close(k, a[k], ref[k])
    assert torch.equal(a["patch_index"], p["patch_index"])

    # PGD on the normalised canvas
    img = (canvas["image"].astype(np.float32) / 255 - 0.5) / 0.5
    hw = canvas["image_hw"]
    img *= (np.arange(32)[None, :, None] < hw[:, :1, None])[..., None]
    img *= (np.arange(48)[None, None, :] < hw[:, 1:, None])[..., None]
    fb = {"image": img, "text_ids": canvas["text_ids"], "text_masks": canvas["text_masks"]}
    k = jax.jit(lambda p, b: jax_l2_normalize(JH.moco_head(
        p["k_moco_head"], ViLTModel(cfg).infer_k(p, b, deterministic=True)["cls_feats"]), 1))(
            params, _j(fb))
    want = jax.jit(JP.make_pgd_moco(ViLTModel(cfg), 2, 0.05, 0.005, 0.07))(
        params, _j(fb), k, state["proj_queue"])
    attack = TP.make_pgd_moco(model, 2, 0.05, 0.005, 0.07)
    kt = torch.from_numpy(np.array(k))
    d = attack(_t(fb), kt, model.proj_queue)
    d_rows = attack(dict(_t(fb), image=to_patch_rows(torch.from_numpy(img), 16)), kt,
                    model.proj_queue)
    assert tuple(d.shape) == img.shape and np.abs(np.asarray(want)).max() > 0
    assert torch.equal(d, from_patch_rows(d_rows, (2, 3), 16))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), atol=DELTA_ATOL, rtol=0)
    with torch.no_grad():
        kp = l2_normalize(model.k_moco_head(model.infer_k(_t(fb))["cls_feats"]), 1)
    _close("keys", kp, k)


# --------------------------------------------------------------- writers
def _png(path, seed, hw=(40, 40)):
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, (*hw, 3), np.uint8)).save(
        path, format="PNG")


def _raw_roots(root):
    """Synthetic raw roots of the seven datasets, as tests/test_data.py
    builds them (a few more images each)."""
    roots = {}
    # coco and f30k karpathy
    for name, subs, js, splits in (
            ("coco", ("train2014", "val2014"), "dataset_coco.json",
             ("train", "val", "test", "restval", "train", "test")),
            ("f30k", ("flickr30k-images",), "dataset_flickr30k.json",
             ("train", "val", "test", "train"))):
        r = root / name
        (r / "karpathy").mkdir(parents=True)
        for s in subs:
            (r / s).mkdir()
        entries = []
        for i, split in enumerate(splits):
            fname = f"{name}{i}.jpg"
            sub = subs[0] if split in ("train", "restval") or len(subs) == 1 else subs[1]
            _png(r / sub / fname, i, (40 + 8 * i, 48))
            entries.append({"filename": fname, "split": split,
                            "sentences": [{"raw": f"a dog in the park {i}"},
                                          {"raw": f"the cat {i}"}]})
        with open(r / "karpathy" / js, "w") as f:
            json.dump({"images": entries}, f)
        roots[name] = r
    # conceptual captions: train (29 shards) and val
    r = root / "gcc"
    for split, n in (("train", 5), ("val", 2)):
        (r / f"images_{split}").mkdir(parents=True)
        with open(r / f"{split}.tsv", "w") as f:
            for i in range(n):
                if i != 3:             # a caption whose image is missing
                    _png(r / f"images_{split}" / str(i), 40 + i)
                f.write(f"a scenic view {i}\thttp://x/{i}\n")
    roots["gcc"] = r
    # sbu
    r = root / "sbu"
    (r / "images").mkdir(parents=True)
    annot = []
    for i in range(4):
        _png(r / "images" / f"s{i}.jpg", 20 + i)
        annot.append({"filename": f"s{i}.jpg", "caption": f"a street scene {i}"})
    with open(r / "annot.json", "w") as f:
        json.dump(annot, f)
    roots["sbu"] = r
    # visual genome
    r = root / "vg"
    (r / "annotations").mkdir(parents=True)
    for sub in ("VG_100K", "VG_100K_2"):
        (r / "images" / sub).mkdir(parents=True)
    regions = []
    for iid in (1, 2, 3):
        _png(r / "images" / ("VG_100K" if iid < 3 else "VG_100K_2") / f"{iid}.jpg", 30 + iid)
        regions.append({"regions": [{"image_id": iid, "phrase": f"a tree {iid}"},
                                    {"image_id": iid, "phrase": f"a car {iid}"}]})
    with open(r / "annotations" / "region_descriptions.json", "w") as f:
        json.dump(regions, f)
    roots["vg"] = r
    # nlvr2: dev (two groups of two sentences), train (one group)
    r = root / "nlvr2"
    (r / "nlvr2" / "data").mkdir(parents=True)
    (r / "dev").mkdir()
    (r / "images" / "train" / "7").mkdir(parents=True)
    for split, n in (("dev", 3), ("train", 2)):
        rows = []
        for i in range(n):
            iden = f"{split}-{i}-0"
            for j in range(2):
                rows.append({"identifier": f"{iden}-{j}", "sentence": f"the dog is big {j}",
                             "label": "True" if (i + j) % 2 == 0 else "False",
                             "directory": "7"})
            d = r / "dev" if split == "dev" else r / "images" / "train" / "7"
            _png(d / f"{iden}-img0.png", 50 + i)
            _png(d / f"{iden}-img1.png", 60 + i)
        with open(r / "nlvr2" / "data" / f"{split}.json", "w") as f:
            f.write("\n".join(json.dumps(x) for x in rows))
    roots["nlvr2"] = r
    # vqa: train and val with answers, test and test-dev without
    r = root / "vqa"
    for d in ("train2014", "val2014", "test2015"):
        (r / d).mkdir(parents=True)
    qs = {"train": [], "val": [], "test": [], "test-dev": []}
    annots = {"train": [], "val": []}
    qid = 0
    for split, dirname, base in (("train", "train2014", 0), ("val", "val2014", 100),
                                 ("test", "test2015", 200)):
        for i in range(3):
            iid = base + i
            _png(r / dirname / f"COCO_{dirname}_{iid:012d}.jpg", iid)
            for q in range(2):
                qs[split].append({"image_id": iid, "question_id": qid,
                                  "question": f"is the dog big {q}"})
                if split == "test":
                    qs["test-dev"].append(qs[split][-1])
                else:
                    answer = ["yes", "no", "2"][(i + q) % 3]
                    annots[split].append({
                        "image_id": iid, "question_id": qid,
                        "multiple_choice_answer": answer,
                        "answers": [{"answer": answer}] * 7 + [{"answer": "yes"}] * 3})
                qid += 1
    for split in ("train", "val"):
        annots[split] += [annots[split][0]] * 9
    files = {"v2_OpenEnded_mscoco_train2014_questions.json": {"questions": qs["train"]},
             "v2_OpenEnded_mscoco_val2014_questions.json": {"questions": qs["val"]},
             "v2_OpenEnded_mscoco_test2015_questions.json": {"questions": qs["test"]},
             "v2_OpenEnded_mscoco_test-dev2015_questions.json": {"questions": qs["test-dev"]},
             "v2_mscoco_train2014_annotations.json": {"annotations": annots["train"]},
             "v2_mscoco_val2014_annotations.json": {"annotations": annots["val"]}}
    for name, obj in files.items():
        with open(r / name, "w") as f:
            json.dump(obj, f)
    roots["vqa"] = r
    return roots


def _same_files(ours, ref):
    names = sorted(os.listdir(ref))
    assert names and sorted(os.listdir(ours)) == names
    for n in names:
        with open(os.path.join(ours, n), "rb") as a, open(os.path.join(ref, n), "rb") as b:
            assert a.read() == b.read(), n


def test_writers_match_jax_byte_for_byte(tmp_path):
    """Every writer of WRITERS on its synthetic raw root, each package from
    the same global ``random`` seed (the writers shuffle the image paths
    with it): the same file names and every table byte for byte; vqa_score
    equal; ``cli.run prepare nlvr2`` writes the same tables and refuses an
    unknown dataset."""
    from rmcl_tpu_torch.cli.run import main
    assert list(TW.WRITERS) == list(JW.WRITERS)
    assert [TW.vqa_score(n) for n in range(8)] == [JW.vqa_score(n) for n in range(8)]
    roots = _raw_roots(tmp_path / "raw")
    for name, root in roots.items():
        ref, ours = tmp_path / "jax" / name, tmp_path / "port" / name
        random.seed(3)
        JW.WRITERS[name](str(root), str(ref))
        random.seed(3)
        TW.WRITERS[name](str(root), str(ours))
        _same_files(str(ours), str(ref))
    out = tmp_path / "cli"
    random.seed(3)
    assert main(["prepare", "nlvr2", f"root={roots['nlvr2']}", f"out={out}"]) == 0
    _same_files(str(out), str(tmp_path / "jax" / "nlvr2"))
    assert main(["prepare", "imagenet", f"root={roots['nlvr2']}", f"out={out}"]) == 2


# ---------------------------------------------------------------- native
def test_native_wordpiece_matches_python_and_jax(tmp_path, monkeypatch):
    """The port's C++ encoder (built with g++ into rmcl_tpu_torch/_build/)
    gives the Python path's ids (a tokenizer made where the loader finds no
    g++) and the JAX package's native ids; a text that is not ASCII takes the
    Python path."""
    lib = _native.load_wordpiece()
    assert lib is not None and _native.load_wordpiece() is lib
    assert str(_native.BUILD_DIR) in lib._name and lib._name.endswith(".so")
    vocab = make_tiny_vocab(str(tmp_path / "v.txt"), ["dog", "running", "park", "the",
                                                      "un", "##aff", "##able", "red"])
    texts = ["The red dog, running in the park!", "unaffable [MASK] dog", "x" * 120,
             "park park park park park park park park park park park", "", "a\tb\nc"]
    ours = WordPieceTokenizer(vocab)
    with monkeypatch.context() as m:
        m.setattr(_native, "load_wordpiece", lambda: None)
        plain = WordPieceTokenizer(vocab)
    ref = JTokenizer(vocab)
    assert ours._native is lib and plain._native is None
    assert jax_load_wordpiece() is not None and ref._native is not None
    for max_len in (8, 16):
        native = ours._batch_encode_native(texts, max_len)
        for a, b, c in zip(native, plain.batch_encode(texts, max_len),
                           ref._batch_encode_native(texts, max_len)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert ours._batch_encode_native(["café dog"], 8) is None
    for a, b in zip(ours.batch_encode(["café dog"], 8), plain.batch_encode(["café dog"], 8)):
        np.testing.assert_array_equal(a, b)


def test_native_resize_and_scatter_match_pil_and_numpy(monkeypatch):
    """The C++ pixelbert chain (resize, bucket fit, normalisation, u8 and
    fp32) equals the PIL path of the same transform and the JAX package's,
    over up-, down- and mixed scaling; the C++ patch-row scatter equals the
    numpy canvas relayout and the JAX package's, u8 and fp32, ragged
    images."""
    lib = _native.load_imageproc()
    assert lib is not None
    r = np.random.RandomState(0)
    for hw in ((300, 500), (500, 300), (100, 420), (37, 53), (64, 96)):
        img = Image.fromarray(r.randint(0, 256, (*hw, 3), np.uint8))
        for size, bucket in ((96, (96, 128)), (64, None), (160, (128, 192))):
            if 0 in TT.min_max_size(hw[1], hw[0], size, int(1333 / 800 * size)):
                continue          # a side under 32 pixels: both paths refuse it
            for dt in ("uint8", "float32"):
                native = TT.pixelbert_transform(size, bucket, out_dtype=dt)(img)
                ref = jax_pixelbert(size, bucket, out_dtype=dt)(img)
                with monkeypatch.context() as m:
                    m.setattr(_native, "load_imageproc", lambda: None)
                    plain = TT.pixelbert_transform(size, bucket, out_dtype=dt)(img)
                assert native.dtype == plain.dtype == np.dtype(dt)
                np.testing.assert_array_equal(native, plain, err_msg=f"{hw} {size} {dt}")
                np.testing.assert_array_equal(native, ref)
    for dtype in (np.uint8, np.float32):
        imgs = [(r.rand(h, w, 3) * 255).astype(dtype)
                for h, w in ((32, 48), (16, 32), (40, 60), (7, 9))]
        fast = TR.images_to_patch_rows(imgs, 32, 48, 16)
        with monkeypatch.context() as m:
            m.setattr(_native, "load_imageproc", lambda: None)
            slow = TR.images_to_patch_rows(imgs, 32, 48, 16)
        assert fast.dtype == slow.dtype == dtype
        np.testing.assert_array_equal(fast, slow)
        np.testing.assert_array_equal(fast, JAD._images_to_patch_rows(imgs, 32, 48, 16))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; without g++
    on PATH the loaders return None (the Python paths run)."""
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_native, "SRC_DIR", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native._compile("broken", "-O2")
    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    assert _native.load_wordpiece() is None and _native.load_imageproc() is None
