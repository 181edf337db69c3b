"""MLM masking collators, numpy host-side (the port's own copy of the JAX
package's ``data/mlm.py``).

Behavioural spec: HF `DataCollatorForLanguageModeling` and
`DataCollatorForWholeWordMask`, selected by `whole_word_masking`
(reference vilt/datamodules/datamodule_base.py:57-65).

Semantics (HF parity):
  * each non-special token is masked with prob `mlm_prob` (0.15);
  * of masked tokens: 80% -> [MASK], 10% -> random vocab id, 10% kept;
  * labels = original id at masked positions, -100 elsewhere.
Whole-word masking reproduces `DataCollatorForWholeWordMask._whole_word_mask`
decision-for-decision (same candidate grouping, same shuffled greedy
selection, same budget `min(512, max(1, round(len(tokens) * p)))` counted
over the unpadded token list INCLUDING [CLS]/[SEP], same skip-when-over
rule with no first-word exception — a long first word CAN yield zero
masks, as in HF).  The shuffle consumes a `random.Random(seed)` stream —
the same Mersenne generator HF's global `random.shuffle` uses, so
seeding both identically gives bit-identical mask patterns
(tests/test_data.py::test_wwm_matches_hf_collator).  The reference feeds
UNPADDED encodings (datamodule_base.py:57-65 collates before padding);
our rows arrive padded, so pad positions are excluded from candidates
and from the budget count — identical effective behaviour.
"""

from __future__ import annotations

import random as pyrandom
from typing import List, Tuple

import numpy as np


class MLMCollator:
    def __init__(self, tokenizer, mlm_prob: float = 0.15,
                 whole_word: bool = False, seed: int = None):
        self.tok = tokenizer
        self.mlm_prob = mlm_prob
        self.whole_word = whole_word
        self.rng = np.random.RandomState(seed)
        self.pyrng = pyrandom.Random(seed)
        self.pad_id = int(getattr(tokenizer, "pad_token_id", 0) or 0)
        self.mask_id = int(tokenizer.mask_token_id
                           if hasattr(tokenizer, "mask_token_id")
                           else tokenizer.convert_tokens_to_ids("[MASK]"))
        self.vocab_size = int(getattr(tokenizer, "vocab_size", 30522))
        # HF clears ALL special ids (incl. [UNK]/[MASK]) from the final
        # mask via get_special_tokens_mask(already_has_special_tokens=True)
        # — AFTER WWM selection, so specials still compete for the budget
        self.all_special_ids = np.asarray(sorted({
            int(getattr(tokenizer, a))
            for a in ("pad_token_id", "unk_token_id", "cls_token_id",
                      "sep_token_id", "mask_token_id")
            if getattr(tokenizer, a, None) is not None}), np.int64)

    def reseed(self, seed: int):
        """Replace the persistent mask RNG streams (kept for direct /
        test callers; loader batches use the scoped per-batch streams
        below instead)."""
        self.rng = np.random.RandomState(seed % (2 ** 32))
        self.pyrng = pyrandom.Random(seed)

    def _streams(self):
        """Per-batch scoped streams when collating inside a loader
        (data/rng.py batch_rng — mask patterns become a pure function
        of batch position, identical across thread/process loaders and
        under mid-epoch resume), else this instance's sequential
        streams (reference-style behavior for ad-hoc callers)."""
        from rmcl_tpu_torch.data.rng import get_batch_streams
        st = get_batch_streams(lambda s: (
            np.random.RandomState(s % (2 ** 32)), pyrandom.Random(s)))
        return st if st is not None else (self.rng, self.pyrng)

    # ------------------------------------------------------------------
    def __call__(self, input_ids: np.ndarray,
                 special_tokens_mask: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids (B, T), special (B, T)) -> (mlm_ids, mlm_labels)."""
        ids = np.array(input_ids, np.int32, copy=True)
        special = np.asarray(special_tokens_mask).astype(bool)
        rng, pyrng = self._streams()

        unmaskable = special | np.isin(ids, self.all_special_ids)
        if self.whole_word:
            # HF: specials other than [CLS]/[SEP] (e.g. [UNK]) COMPETE in
            # the selection, then get cleared from the final mask
            masked = self._whole_word_mask(ids, special, pyrng) & ~unmaskable
        else:
            prob = np.full(ids.shape, self.mlm_prob)
            prob[unmaskable] = 0.0
            masked = rng.random_sample(ids.shape) < prob

        labels = np.where(masked, ids, -100).astype(np.int32)

        replace = masked & (rng.random_sample(ids.shape) < 0.8)
        ids[replace] = self.mask_id
        randomize = (masked & ~replace
                     & (rng.random_sample(ids.shape) < 0.5))
        ids[randomize] = rng.randint(
            0, self.vocab_size, int(randomize.sum()))
        return ids, labels

    # ------------------------------------------------------------------
    def _word_groups(self, row_ids: np.ndarray,
                     special_row: np.ndarray) -> List[List[int]]:
        toks = self.tok.convert_ids_to_tokens(
            [int(i) for i in row_ids])
        groups: List[List[int]] = []
        for pos, (t, sp) in enumerate(zip(toks, special_row)):
            if sp:
                continue
            if t.startswith("##") and groups:
                groups[-1].append(pos)
            else:
                groups.append([pos])
        return groups

    def _whole_word_mask(self, ids: np.ndarray, special: np.ndarray,
                         pyrng: pyrandom.Random) -> np.ndarray:
        """HF `DataCollatorForWholeWordMask._whole_word_mask` semantics,
        one call per batch row (HF shuffles per example in sequence,
        consuming the same RNG stream order)."""
        masked = np.zeros(ids.shape, bool)
        for b in range(ids.shape[0]):
            groups = self._word_groups(ids[b], special[b])
            # HF budget counts the full (unpadded) token list incl.
            # [CLS]/[SEP]; our rows are padded, so count non-pad
            n_tokens = int((ids[b] != self.pad_id).sum())
            budget = min(512, max(1, int(round(n_tokens * self.mlm_prob))))
            pyrng.shuffle(groups)
            covered = 0
            for g in groups:
                if covered >= budget:
                    break
                if covered + len(g) > budget:
                    continue
                for pos in g:
                    masked[b, pos] = True
                covered += len(g)
        return masked
