"""Benign (non-adversarial) view augmentation: the port's own copy of the JAX
package's ``data/augmentation.py`` (EDA text views, SimCLR image views).

Behavioural spec: reference augmentation/{eda.py,text_augmentation.py,
image_augmentation.py}, used when ``augmentation=True`` instead of the
adversarial views (reference objectives.py:278-279, 320-321).  Every draw
goes through ``data/rng.py:srandom`` in the JAX package's order, and the
candidate and synonym sets are built as it builds them (``list(set(...))``),
so one seed gives the same sentences and the same pixels within a process.

As in the JAX package:
  * ``TextAugmentation.augment`` returns the selected sentences (the
    reference assigned the last loop iteration's candidates,
    text_augmentation.py:48);
  * ``ImageAugmentation`` has no debug ``show(...)`` / ``sys.exit``
    (reference image_augmentation.py:208);
  * the PEGASUS paraphraser and the SBERT ranker are optional: without them
    the candidates are EDA's and the ranking is a token-level Jaccard
    similarity.

One divergence from the JAX package: the SBERT ranker is loaded from local
files only (``local_files_only=True``, as both packages load PEGASUS), so a
machine without the network never waits on it; the JAX package asks the hub
for it.  On a machine with neither model cached both rank by Jaccard.

Synonyms for EDA come from nltk WordNet when its data is installed, else a
counter-fitted-vector ``SynonymTable``, else identity (no replacement).
PIL is imported inside the functions that touch an image.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np

from rmcl_tpu_torch.data.rng import srandom
from rmcl_tpu_torch.data.transforms import min_max_resize, to_normalized_array

# EDA stopword list (reference augmentation/eda.py:10-33)
STOP_WORDS = set("""i me my myself we our ours ourselves you your yours
yourself yourselves he him his himself she her hers herself it its itself
they them their theirs themselves what which who whom this that these those
am is are was were be been being have has had having do does did doing a an
the and but if or because as until while of at by for with about against
between into through during before after above below to from up down in out
on off over under again further then once here there when where why how all
any both each few more most other some such no nor not only own same so than
too very s t can will just don should now""".split())


def get_only_chars(line: str) -> str:
    """Lowercase, keep [a-z ], collapse whitespace (reference eda.py:36-55)."""
    line = line.replace("'", "").replace("-", " ").replace("\t", " ") \
               .replace("\n", " ").lower()
    line = re.sub(r"[^a-z ]", " ", line)
    line = re.sub(r" +", " ", line).strip()
    return line


# ----------------------------------------------------------- synonym source
class _WordnetSource:
    def __init__(self):
        from nltk.corpus import wordnet
        wordnet.synsets("test")          # raises if the data is missing
        self._wn = wordnet

    def __call__(self, word: str) -> List[str]:
        out = set()
        for syn in self._wn.synsets(word):
            for lemma in syn.lemmas():
                w = lemma.name().replace("_", " ").replace("-", " ").lower()
                w = "".join(c for c in w if c.isalpha() or c == " ")
                out.add(w)
        out.discard(word)
        return list(out)


class _TableSource:
    def __init__(self, table):
        self.table = table  # attacks/greedy.py:SynonymTable

    def __call__(self, word: str) -> List[str]:
        c = self.table.candidates(word)
        return [w for w in c if w != word]


def default_synonym_source(synonym_table=None) -> Callable[[str], List[str]]:
    try:
        return _WordnetSource()
    except Exception:        # nltk or its WordNet data missing: the next source
        pass
    if synonym_table is not None:
        return _TableSource(synonym_table)
    return lambda word: []


# ------------------------------------------------------------------ EDA ops
def synonym_replacement(words: List[str], n: int, syn) -> List[str]:
    """Replace up to n non-stopwords with synonyms (reference eda.py:62-88)."""
    new_words = list(words)
    candidates = list(set(w for w in words if w not in STOP_WORDS))
    srandom.shuffle(candidates)
    replaced = 0
    for w in candidates:
        synonyms = syn(w)
        if synonyms:
            pick = srandom.choice(synonyms)
            new_words = [pick if x == w else x for x in new_words]
            replaced += 1
        if replaced >= n:
            break
    return " ".join(new_words).split(" ")


def random_insertion(words: List[str], n: int, syn) -> List[str]:
    """Insert synonyms of random words at random slots (eda.py:109-127)."""
    new_words = list(words)
    for _ in range(n):
        for _ in range(10):
            w = srandom.choice(new_words) if new_words else ""
            synonyms = syn(w)
            if synonyms:
                new_words.insert(srandom.randint(0, len(new_words)),
                                 srandom.choice(synonyms))
                break
    return new_words


def random_swap(words: List[str], n: int) -> List[str]:
    """Swap two random positions n times (reference eda.py:133-151)."""
    new_words = list(words)
    for _ in range(n):
        if len(new_words) < 2:
            break
        i1 = srandom.randint(0, len(new_words) - 1)
        i2 = i1
        for _ in range(3):
            i2 = srandom.randint(0, len(new_words) - 1)
            if i2 != i1:
                break
        new_words[i1], new_words[i2] = new_words[i2], new_words[i1]
    return new_words


def random_deletion(words: List[str], p: float) -> List[str]:
    """Delete each word with prob p; never return empty (eda.py:157-174)."""
    if len(words) == 1:
        return list(words)
    kept = [w for w in words if srandom.uniform(0, 1) > p]
    return kept if kept else [srandom.choice(words)]


def eda(sentence: str, alpha_sr=0.1, alpha_ri=0.1, alpha_rs=0.1, p_rd=0.1,
        num_aug: int = 1, original: bool = False,
        syn: Optional[Callable] = None) -> List[str]:
    """4-technique EDA (reference eda.py:183-238)."""
    syn = syn or default_synonym_source()
    sentence = get_only_chars(sentence)
    words = [w for w in sentence.split(" ") if w]
    n_words = max(len(words), 1)
    out: List[str] = []
    per = num_aug // 4 + 1
    for _ in range(per):
        out.append(" ".join(synonym_replacement(
            words, max(1, int(alpha_sr * n_words)), syn) + ["."]))
    for _ in range(per):
        out.append(" ".join(random_insertion(
            words, max(1, int(alpha_ri * n_words)), syn) + ["."]))
    for _ in range(per):
        out.append(" ".join(random_swap(
            words, max(1, int(alpha_rs * n_words))) + ["."]))
    for _ in range(per):
        out.append(" ".join(random_deletion(words, p_rd) + ["."]))
    out = [get_only_chars(s) for s in out]
    srandom.shuffle(out)
    if num_aug >= 1:
        out = out[:num_aug]
    if original:
        out.append(sentence)
    return out


# --------------------------------------------------------- text augmentation
def _jaccard(a: str, b: str) -> float:
    sa, sb = set(a.split()), set(b.split())
    return len(sa & sb) / max(len(sa | sb), 1)


class TextAugmentation:
    """PEGASUS paraphrase + EDA candidate pool, ranked by similarity to the
    original; pick the epoch-th most similar (reference
    text_augmentation.py:19-52).  Both models load from local files only:
    where neither is cached the pool is EDA's and the ranking Jaccard's."""

    def __init__(self, cfg, tokenizer, synonym_table=None,
                 use_pegasus: Optional[bool] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.syn = default_synonym_source(synonym_table)
        self.pegasus = None
        self.ranker = None
        if use_pegasus is None:
            use_pegasus = "PEGASUS" in cfg.type_txt_augm
        if use_pegasus:
            try:
                from transformers import (PegasusForConditionalGeneration,
                                          PegasusTokenizer)
                self.pegasus_tok = PegasusTokenizer.from_pretrained(
                    "tuner007/pegasus_paraphrase", local_files_only=True)
                self.pegasus = PegasusForConditionalGeneration.from_pretrained(
                    "tuner007/pegasus_paraphrase", local_files_only=True)
            except Exception:    # not installed or not cached: EDA only
                self.pegasus = None
        try:
            from sentence_transformers import SentenceTransformer, util
            self.ranker = SentenceTransformer("paraphrase-MiniLM-L6-v2",
                                              local_files_only=True)
            self._util = util
        except Exception:        # not installed or not cached: Jaccard
            self.ranker = None

    def _candidates(self, sentence: str) -> List[str]:
        cands: List[str] = []
        if self.pegasus is not None and "PEGASUS" in self.cfg.type_txt_augm:
            import torch
            enc = self.pegasus_tok([sentence], truncation=True,
                                   padding="longest", return_tensors="pt")
            with torch.no_grad():
                gen = self.pegasus.generate(
                    **enc, max_length=self.cfg.max_text_len,
                    num_beams=self.cfg.num_beams,
                    num_return_sequences=self.cfg.num_return_sequences)
            cands += self.pegasus_tok.batch_decode(gen,
                                                   skip_special_tokens=True)
        if "EDA" in self.cfg.type_txt_augm or not cands:
            cands += eda(sentence, num_aug=self.cfg.num_return_sequences,
                         syn=self.syn)
        return cands

    def _rank(self, original: str, cands: List[str]) -> List[int]:
        if self.ranker is not None:
            import torch
            ce = self.ranker.encode(cands, show_progress_bar=False)
            oe = self.ranker.encode(original, show_progress_bar=False)
            sims = self._util.pytorch_cos_sim(
                torch.tensor(oe)[None], torch.tensor(ce))[0]
            return list(np.argsort(-np.asarray(sims)))
        sims = np.asarray([_jaccard(original, c) for c in cands])
        return list(np.argsort(-sims))

    def augment(self, texts: Sequence[str], epoch: int = 0):
        """Returns (texts, text_ids, text_masks) numpy arrays."""
        final: List[str] = []
        for sentence in texts:
            cands = self._candidates(sentence)
            order = self._rank(sentence, cands)
            final.append(cands[order[min(epoch, len(order) - 1)]])
        ids, masks = self.tokenizer.batch_encode(final,
                                                 self.cfg.max_text_len)
        return final, ids, masks


# -------------------------------------------------------- image augmentation
def _random_resized_crop(img, out_size: int = 224,
                         scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    from PIL import Image
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = srandom.uniform(*scale) * area
        ar = np.exp(srandom.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = srandom.randint(0, w - cw)
            y = srandom.randint(0, h - ch)
            return img.resize((out_size, out_size), Image.BICUBIC,
                              box=(x, y, x + cw, y + ch))
    return img.resize((out_size, out_size), Image.BICUBIC)


def _color_jitter(img, brightness=0.4, contrast=0.4, saturation=0.2,
                  hue=0.1):
    from PIL import ImageEnhance
    ops = [
        lambda im: ImageEnhance.Brightness(im).enhance(
            srandom.uniform(1 - brightness, 1 + brightness)),
        lambda im: ImageEnhance.Contrast(im).enhance(
            srandom.uniform(1 - contrast, 1 + contrast)),
        lambda im: ImageEnhance.Color(im).enhance(
            srandom.uniform(1 - saturation, 1 + saturation)),
        lambda im: _hue_shift(im, srandom.uniform(-hue, hue)),
    ]
    srandom.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def _hue_shift(img, factor: float):
    from PIL import Image
    if abs(factor) < 1e-6:
        return img
    hsv = np.asarray(img.convert("HSV"), np.uint8).copy()
    hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                   + int(factor * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")


class SimCLRTransform:
    """BT-style pipeline then the pixelbert resize and normalisation
    (reference image_augmentation.py Transform:96-116)."""

    def __init__(self, size: int = 384):
        self.size = size
        self.longer = int((1333 / 800) * size)

    def __call__(self, img) -> np.ndarray:
        from PIL import ImageFilter, ImageOps
        img = _random_resized_crop(img, 224)
        if srandom.random() < 0.5:
            img = ImageOps.mirror(img)
        if srandom.random() < 0.8:
            img = _color_jitter(img)
        if srandom.random() < 0.2:
            img = img.convert("L").convert("RGB")
        img = img.filter(ImageFilter.GaussianBlur(
            radius=srandom.uniform(0.1, 2.0)))            # p=1.0
        if srandom.random() < 0.2:
            img = ImageOps.solarize(img)
        img = min_max_resize(img, shorter=self.size, longer=self.longer)
        return to_normalized_array(img)


class ImageAugmentation:
    """Benign image views re-read from the arrow table by img_index
    (reference image_augmentation.py:120-209, debug sys.exit removed)."""

    def __init__(self, dataset, size: int = 384):
        self.dataset = dataset
        self.transform = SimCLRTransform(size)

    def augment_indices(self, img_indices: Sequence[int],
                        bucket_hw) -> np.ndarray:
        """(B, H, W, 3) float32 canvas of the views, top-left aligned."""
        H, W = bucket_hw
        out = np.zeros((len(img_indices), H, W, 3), np.float32)
        row_to_sample = getattr(self.dataset, "_row_to_sample", None)
        if row_to_sample is None:
            row_to_sample = {}
            for i, (row, _) in self.dataset.index_mapper.items():
                row_to_sample.setdefault(row, i)
            self.dataset._row_to_sample = row_to_sample
        for i, row in enumerate(img_indices):
            img = self.dataset.get_raw_image(row_to_sample[int(row)])
            arr = self.transform(img)
            h, w = min(arr.shape[0], H), min(arr.shape[1], W)
            out[i, :h, :w] = arr[:h, :w]
        return out
