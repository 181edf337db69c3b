"""Self-contained WordPiece tokenizer (BERT-uncased compatible); the port's
own copy of the JAX package's ``data/tokenizer.py``.  ``batch_encode`` of
ASCII texts runs the C++ encoder of ``data/_native/wordpiece.cpp`` where
``g++`` is on PATH (built at first use), the Python path otherwise; the ids
are the same.

The reference relies on HF ``BertTokenizer.from_pretrained("bert-base-
uncased")`` (reference vilt/datamodules/datamodule_base.py:12-27), which
needs network access, so this loads any BERT vocab.txt and implements the
same algorithm: basic tokenisation (lowercase, accent strip, punctuation
split, CJK isolation) followed by greedy longest-match-first WordPiece with
"##" continuations.

If ``transformers`` can resolve the named tokenizer locally (cache/dir),
``get_tokenizer`` prefers it; otherwise it falls back to this class.
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_whitespace(ch):
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    def __init__(self, vocab_path: str, do_lower_case: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token_id = self.vocab[PAD]
        self.unk_token_id = self.vocab[UNK]
        self.cls_token_id = self.vocab[CLS]
        self.sep_token_id = self.vocab[SEP]
        self.mask_token_id = self.vocab[MASK]
        # the C++ batch encoder for ASCII texts, where its table is this one
        # (a vocabulary with repeated lines is not: the Python path keeps it)
        self._native = self._native_handle = None
        from rmcl_tpu_torch.data import _native
        lib = _native.load_wordpiece()
        if lib is not None:
            h = lib.wp_create(vocab_path.encode())
            if not h:
                raise RuntimeError(f"wp_create could not read {vocab_path}")
            if lib.wp_vocab_size(h) == len(self.vocab):
                self._native, self._native_handle = lib, h
            else:
                lib.wp_free(h)

    def __del__(self):
        if getattr(self, "_native_handle", None):
            self._native.wp_free(self._native_handle)
            self._native_handle = None

    # HF-compatible aliases
    @property
    def mask_token(self):
        return MASK

    @property
    def vocab_size(self):
        return len(self.vocab)

    def get_vocab(self):
        return dict(self.vocab)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            return self.inv_vocab.get(int(ids), UNK)
        return [self.inv_vocab.get(int(i), UNK) for i in ids]

    def _convert_token_to_id(self, token):  # reference-API parity
        return self.convert_tokens_to_ids(token)

    # ----------------------------------------------------------- basic
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        # isolate CJK
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.extend([" ", ch, " "])
            else:
                chars.append(ch)
        text = "".join(chars)
        tokens: List[str] = []
        for tok in text.strip().split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punct(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # ------------------------------------------------------- wordpiece
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        out: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [UNK]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        # HF parity: special tokens in the input text are never split
        # (BertTokenizer never_split) — needed for "[MASK]" round-trips.
        toks: List[str] = []
        pattern = re.compile(
            "(" + "|".join(re.escape(s) for s in (PAD, UNK, CLS, SEP, MASK))
            + ")")
        for part in pattern.split(text):
            if not part:
                continue
            if part in (PAD, UNK, CLS, SEP, MASK):
                toks.append(part)
                continue
            for w in self.basic_tokenize(part):
                toks.extend(self.wordpiece(w))
        return toks

    # --------------------------------------------------------- encode
    def encode(self, text: str, max_length: int,
               padding: str = "max_length", truncation: bool = True):
        toks = self.tokenize(text)
        if truncation:
            toks = toks[: max_length - 2]
        ids = ([self.cls_token_id] + self.convert_tokens_to_ids(toks)
               + [self.sep_token_id])
        special = [1] + [0] * len(toks) + [1]
        attn = [1] * len(ids)
        if padding == "max_length":
            pad_n = max_length - len(ids)
            ids += [self.pad_token_id] * pad_n
            attn += [0] * pad_n
            special += [1] * pad_n
        return {"input_ids": ids, "attention_mask": attn,
                "special_tokens_mask": special}

    def __call__(self, texts, max_length: int = 40, padding="max_length",
                 truncation=True, return_special_tokens_mask=True,
                 return_tensors: Optional[str] = None):
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        encs = [self.encode(t, max_length, padding, truncation) for t in texts]
        out = {k: [e[k] for e in encs] for k in encs[0]}
        if single:  # HF parity: a single string yields flat lists
            out = {k: v[0] for k, v in out.items()}
        if return_tensors == "np":
            out = {k: np.asarray(v, np.int32) for k, v in out.items()}
        return out

    def batch_encode(self, texts: Sequence[str], max_length: int):
        native = self._batch_encode_native(texts, max_length)
        if native is not None:
            return native
        enc = self(list(texts), max_length=max_length, return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]

    def _batch_encode_native(self, texts: Sequence[str], max_length: int):
        """The C++ encoder (``data/_native/wordpiece.cpp``) for ASCII texts;
        None for a batch with any other text, or without the encoder."""
        if self._native is None or not texts:
            return None
        import ctypes
        try:
            blobs = [t.encode("ascii") for t in texts]
        except UnicodeEncodeError:
            return None
        n = len(blobs)
        offsets = np.zeros((n + 1,), np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        ids = np.zeros((n, max_length), np.int32)
        mask = np.zeros((n, max_length), np.int32)
        rc = self._native.wp_encode_batch(
            self._native_handle, b"".join(blobs),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, max_length,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"wp_encode_batch failed ({rc})")
        return ids, mask

    def decode(self, ids, skip_special_tokens: bool = True,
               clean_up_tokenization_spaces: bool = False) -> str:
        special = {self.pad_token_id, self.cls_token_id, self.sep_token_id}
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special:
                continue
            toks.append(self.inv_vocab.get(i, UNK))
        # join wordpieces
        words: List[str] = []
        for t in toks:
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)


def make_tiny_vocab(path: str, words: Sequence[str]):
    """Write a minimal vocab.txt for tests."""
    base = [PAD, UNK, CLS, SEP, MASK]
    pieces: List[str] = list(base)
    seen = set(base)
    for w in words:
        for piece in (w, *("##" + w[i:] for i in (1, 2) if len(w) > i)):
            if piece not in seen:
                pieces.append(piece)
                seen.add(piece)
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789.,!?'\"-":
        if ch not in seen:
            pieces.append(ch)
            seen.add(ch)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(pieces) + "\n")
    return path


def get_tokenizer(name_or_path: str, vocab_path: Optional[str] = None):
    """Resolve a tokenizer: explicit vocab file > local dir > HF local
    cache > error.  (Rank-0 download + barrier of the reference,
    datamodule_base.py:12-27, is unnecessary: no network here.)"""
    if vocab_path and os.path.isfile(vocab_path):
        return WordPieceTokenizer(vocab_path)
    if os.path.isfile(name_or_path):
        return WordPieceTokenizer(name_or_path)
    if os.path.isdir(name_or_path):
        cand = os.path.join(name_or_path, "vocab.txt")
        if os.path.isfile(cand):
            return WordPieceTokenizer(cand)
    try:
        from transformers import BertTokenizerFast
        return BertTokenizerFast.from_pretrained(name_or_path,
                                                 local_files_only=True)
    except Exception as e:
        raise FileNotFoundError(
            f"Cannot resolve tokenizer {name_or_path!r}: no vocab.txt and "
            f"no local HF cache ({e}). Pass an explicit vocab path."
        )
