"""The greedy word-substitution attack with its loop on the device (port of
``rmcl_tpu/attacks/greedy_fused.py``: ``TABLE_KEYS``, ``build_sequences`` and
``FusedGreedyAttack``).

An invariant of the reference algorithm makes the loop array work: a word
index enters ``history`` when it is picked and is never picked again, so
every substitution candidate refers to an original word.  All string work
(decode, per-word tokenisation, synonym lookup) is done once per batch on the
host into static tables (``_prep``):

    word_tok   (B, W, M)     sub-token ids of word w (padded)
    word_len   (B, W)        number of sub-tokens
    attackable (B, W)        not a stop/function word AND in the synonym
                             vocabulary (greedy.py check_word + synonyms)
    cand_tok   (B, W, NC, M) candidate sub-token ids
    cand_len   (B, W, NC)
    cand_valid (B, W, NC)    candidate differs from the original word
                             (invalid slots hold the original word, like the
                             host's pad-with-base-sentence rows)

and each loop is tensor work on the device (``build_attack_body``): the
saliency gradient, the masked argmax pick, the candidate sequences by a
sub-token splice (WordPiece is whitespace-separable), one (B * NC)-row
scoring forward, the commit of the best candidate iff it raises the
per-sample loss (strict >), the history and budget bookkeeping.

The JAX package runs the loop as one program (``lax.while_loop``,
``lax.cond``).  Eager torch reads one small packed tensor per loop on the
host (``read`` in ``_run``): the live count, which ends the loop early or
moves it to the next compaction stage, and whether any sample committed,
which decides whether the next loop needs a gradient pass; plus one read of
the initial live count.
Over several processes a framework whose loss couples the batch
(BarlowTwins: ``per_sample_independent`` False) reads the counts summed over
ranks, so that every rank runs the same loops and gradient passes, each
with its collectives; a per-sample framework keeps its own exit and
compaction (its loops run no collective).
The compaction order stays on the device.  ``last_stats`` counts the loops,
the gradient passes, the scoring forwards and the host reads of the last
attack.  Exact shortcuts kept from the JAX package:

  * the early exit once no sample has an eligible pick after the commit;
  * the reuse of saliency and losses when no sample committed (the
    deterministic forward would give the same values);
  * live-set compaction, a cascade of two stages (``greedy_compact_frac``);
  * scoring in chunks of the candidate axis (``greedy_score_max_rows``);
  * the attack's own text bucket (``_text_bucket``).

Not ported: the collapse of the text bucket back to ``max_text_len`` when it
does not lower the TPU's padded sequence length.  The CUDA kernels pad
nothing, so a shorter text always shortens S.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rmcl_tpu_torch.attacks.greedy import GreedyAttack, check_word
from rmcl_tpu_torch.attacks.pgd import _frozen
from rmcl_tpu_torch.core.buckets import bucket_enabled, text_bucket
from rmcl_tpu_torch.parallel.dist import sum_over_ranks

_NEG = -1e30

# batch keys carrying the host-precomputed attack tables into the attacked
# train step (train/step.py make_attacked_train_step)
TABLE_KEYS = ("gw_tok", "gw_len", "gw_attackable", "gw_cand_tok",
              "gw_cand_len", "gw_cand_valid", "gw_tbucket", "gw_nw")


def build_sequences(word_tok, word_len, T: int, cls_id: int, sep_id: int,
                    pad_id: int):
    """(B, W, M) per-word sub-tokens -> ([CLS] w0 w1 ... [SEP] pad) ids +
    attention masks (B, T) int32, truncated to T-2 sub-tokens exactly like
    tokenizer.encode (data/tokenizer.py)."""
    B, W, M = word_tok.shape
    dev = word_tok.device
    ar_m = torch.arange(M, device=dev)
    off = torch.cumsum(word_len, dim=1) - word_len              # (B, W)
    gpos = off[:, :, None] + ar_m                               # (B, W, M)
    valid = (ar_m < word_len[:, :, None]) & (gpos < T - 2)
    # invalid entries all land on scratch slot T-1: several writes to one
    # slot leave any one of them, which the SEP write and the clearing
    # below then overwrite
    pos = torch.where(valid, gpos + 1, T - 1)
    ids = torch.full((B, T), pad_id, dtype=torch.int32, device=dev)
    ids[:, 0] = cls_id
    b_idx = torch.arange(B, device=dev)[:, None, None].expand(B, W, M)
    ids[b_idx, pos] = word_tok.to(torch.int32)
    total = torch.clamp(word_len.sum(dim=1), max=T - 2)        # (B,)
    ids[torch.arange(B, device=dev), total + 1] = sep_id
    tpos = torch.arange(T, device=dev)[None, :]
    ids = torch.where(tpos > total[:, None] + 1, pad_id, ids)
    masks = (tpos <= total[:, None] + 1).to(torch.int32)
    return ids, masks


def _saliency(grads, word_len, M: int, Ts: int):
    """(B, Ts, C) gradients, (B, W) word lengths -> (B, W): the L1 norm of
    each word's mean sub-token gradient ([CLS] is position 0)."""
    dev = grads.device
    ar_m = torch.arange(M, device=dev)
    off = torch.cumsum(word_len, dim=1) - word_len
    pos = torch.clamp(off[:, :, None] + ar_m + 1, 0, Ts - 1)
    valid = ar_m < word_len[:, :, None]
    b_idx = torch.arange(grads.shape[0], device=dev)[:, None, None]
    g = grads[b_idx, pos] * valid[..., None]                    # (B, W, M, C)
    mean = g.sum(2) / torch.clamp(word_len, min=1)[..., None]
    return mean.abs().sum(-1)


class FusedGreedyAttack:
    """Drop-in for GreedyAttack.adv_attack_samples with the loop on the
    device.  Wraps a GreedyAttack subclass and reuses its loss_per_sample /
    score_candidates / tile_extras / compact_extras hooks unchanged."""

    def __init__(self, base: GreedyAttack):
        self.base = base
        self._word_ids_cache: Dict[str, List[int]] = {}
        self._cand_cache: Dict[str, List[str]] = {}
        self.last_stats: Dict[str, int] = {}
        # None, or a list each loop appends its decisions to, on the host:
        # the batch rows it ran on, the eligible words' saliency (_NEG
        # elsewhere), pick, the valid candidates' scores (_NEG elsewhere),
        # the per-sample loss, best and improved (to find where two runs of
        # the attack part, and by what margin)
        self.record = None

    # ------------------------------------------------------------- host
    def _word_ids(self, w: str) -> List[int]:
        ids = self._word_ids_cache.get(w)
        if ids is None:
            tok = self.base.tokenizer
            ids = tok.convert_tokens_to_ids(tok.tokenize(w))
            self._word_ids_cache[w] = ids
        return ids

    def _cands(self, w: str) -> List[str]:
        c = self._cand_cache.get(w)
        if c is None:
            c = list(self.base.synonyms.candidates(w))[: self.base.n_candidates]
            self._cand_cache[w] = c
        return c

    def _prep(self, ids0: np.ndarray):
        """Decode once, build the static word/candidate tables."""
        tok = self.base.tokenizer
        B = ids0.shape[0]
        W = self.base.max_length
        NC = self.base.n_candidates
        words_list = [tok.decode(ids, skip_special_tokens=True).split(" ")
                      for ids in ids0]

        # M bucket: longest sub-tokenisation among words AND candidates
        m = 1
        for words in words_list:
            for w in words[:W]:
                m = max(m, len(self._word_ids(w)))
                lw = w.strip().lower()
                if not check_word(lw) and lw in self.base.synonyms:
                    for c in self._cands(lw):
                        m = max(m, len(self._word_ids(c)))
        M = 4
        while M < m:
            M *= 2

        word_tok = np.zeros((B, W, M), np.int32)
        word_len = np.zeros((B, W), np.int32)
        attackable = np.zeros((B, W), bool)
        cand_tok = np.zeros((B, W, NC, M), np.int32)
        cand_len = np.zeros((B, W, NC), np.int32)
        cand_valid = np.zeros((B, W, NC), bool)
        nw = np.zeros((B,), np.int32)

        for i, words in enumerate(words_list):
            nw[i] = len(words)
            for w_idx, w in enumerate(words[:W]):
                ids = self._word_ids(w)
                word_len[i, w_idx] = len(ids)
                word_tok[i, w_idx, :len(ids)] = ids
                lw = w.strip().lower()
                ok = not check_word(lw) and lw in self.base.synonyms
                attackable[i, w_idx] = ok
                # invalid candidate slots carry the original word so the
                # scored sentence is the unmodified one (the host pads rows
                # with the base sentence)
                cand_tok[i, w_idx, :, :len(ids)] = ids
                cand_len[i, w_idx, :] = len(ids)
                if not ok:
                    continue
                for j, c in enumerate(self._cands(lw)):
                    cids = self._word_ids(c)
                    cand_tok[i, w_idx, j, :] = 0
                    cand_tok[i, w_idx, j, :len(cids)] = cids
                    cand_len[i, w_idx, j] = len(cids)
                    cand_valid[i, w_idx, j] = c != w
        Ts = self._text_bucket(word_len, cand_len)
        return (word_tok, word_len, attackable, cand_tok, cand_len,
                cand_valid, nw, words_list, M, Ts)

    def _text_bucket(self, word_len: np.ndarray, cand_len: np.ndarray) -> int:
        """Static text length of the attack's internal forwards (saliency
        gradient and candidate scoring), rounded to /8.

        All candidates of a caption share its valid length, so the attack
        can run its sequences in a smaller bucket exactly, provided no
        candidate sequence can outgrow it: the bound is the initial length
        + (most commits) x (largest candidate growth) + CLS + SEP, the
        commit count the fixed point of the reference's 20%-of-words budget
        (which grows as substitutions lengthen the text).  The returned ids
        are at max_text_len either way.  Disable: cfg
        attack_text_bucket=False."""
        T = self.base.max_length
        if not bucket_enabled(self.base.cfg, "attack"):
            return T
        total0 = int(word_len.sum(axis=1).max()) if word_len.size else 0
        growth = max(int(cand_len.max()) - 1, 0) if cand_len.size else 0
        k = 0
        for _ in range(self.base.max_loops + 1):
            k2 = min(self.base.max_loops, int(0.2 * (total0 + k * growth + 1)))
            if k2 <= k:
                break
            k = k2
        return text_bucket(total0 + k * growth + 2, T)

    def prep_tables(self, ids0) -> Dict[str, np.ndarray]:
        """Host precompute for the attacked train step: the static
        word/candidate tables as a dict of TABLE_KEYS arrays to merge into
        the batch (batch dim first).  The text bucket travels as the shape
        (B, Ts) of ``gw_tbucket``."""
        (wt, wl, att, ct, cl, cv, nw, _, _, Ts) = self._prep(np.asarray(ids0))
        B = wt.shape[0]
        return {"gw_tok": wt, "gw_len": wl, "gw_attackable": att,
                "gw_cand_tok": ct, "gw_cand_len": cl, "gw_cand_valid": cv,
                "gw_tbucket": np.zeros((B, Ts), np.int8), "gw_nw": nw}

    # ----------------------------------------------------------- device
    def build_attack_body(self):
        """The attack on device tensors: fn(batch, extras, word_tok,
        word_len, attackable, cand_tok, cand_len, cand_valid, tbucket=None,
        block_matrices=None) -> (ids, masks, n_changed), ids and masks (B,
        max_text_len) int32, n_changed (B,) int32, all on the device.
        ``batch``: the attacker's images (``image``, or NLVR2's ``image_0`` and
        ``image_1``; with their ``_hw`` for u8) on the model's device;
        ``block_matrices``: the query transformer's matrices in the compute
        type (else cast here)."""
        return self._attack

    def _attack(self, batch, extras, word_tok, word_len, attackable, cand_tok,
                cand_len, cand_valid, tbucket=None, block_matrices=None):
        base = self.base
        with _frozen(base.model):
            mats = base.matrices(block_matrices)
            img = base.image_side(batch)
            return self._run(img, extras, word_tok, word_len, attackable, cand_tok,
                             cand_len, cand_valid, tbucket, mats)

    def _run(self, img, extras, word_tok, word_len, attackable, cand_tok,
             cand_len, cand_valid, tbucket, mats):
        base = self.base
        tok = base.tokenizer
        T, NC, max_loops = base.max_length, base.n_candidates, base.max_loops
        ids_of = dict(cls_id=tok.cls_token_id, sep_id=tok.sep_token_id,
                      pad_id=tok.pad_token_id)
        B, W = word_len.shape
        M = word_tok.shape[-1]
        dev = word_len.device
        # the attack's own text bucket (_text_bucket): exact by construction
        Ts = min(T, tbucket.shape[1]) if tbucket is not None else T
        stats = dict(loops=0, grad_passes=0, score_forwards=0, host_reads=0)
        self.last_stats = stats

        def eligibility(word_len_, history_, n_changed_, attackable_):
            # the host mapping's truncation: words stay eligible only while
            # the running offset fits max_length; the budget at the SEP
            # index = mask sum - 1 (reference greedy_attack_vilt.py:288)
            incl = torch.cumprod((torch.cumsum(word_len_, dim=1) < T).to(torch.int32),
                                 dim=1).bool()
            total = torch.clamp(word_len_.sum(dim=1), max=Ts - 2)
            max_changes = torch.clamp(
                ((total + 1).to(torch.float32) * 0.2).to(torch.int32), max=max_loops)
            return (attackable_ & incl & ~history_
                    & (n_changed_ < max_changes)[:, None])

        def read(*values) -> List[int]:
            """One host read of a few device scalars, packed; summed over
            ranks for a framework whose loss couples the batch."""
            stats["host_reads"] += 1
            packed = torch.stack([v.to(torch.int64) for v in values])
            if not base.per_sample_independent:
                packed = sum_over_ranks(packed)
            return packed.tolist()

        def body(state, rows, img_c, extras_c, att_c, ctok_c, clen_c, cval_c):
            wt, wl, history, n_changed, sal, per_loss, aux, need_grad = state
            Bc = wl.shape[0]
            b_idx = torch.arange(Bc, device=dev)
            ids, masks = build_sequences(wt, wl, Ts, **ids_of)
            batch = dict(img_c, text_ids=ids, text_masks=masks)
            if need_grad:
                # per-sample losses and saliencies change only on commit, so
                # a loop after one with no commit reuses them (exact)
                stats["grad_passes"] += 1
                per, grads, aux = base.grad_pass(batch, extras_c, mats)
                sal = _saliency(grads, wl, M, Ts)
                per_loss = per.float()
            eligible = eligibility(wl, history, n_changed, att_c)
            has_pick = eligible.any(dim=1)
            pick = torch.argmax(torch.where(eligible, sal, _NEG), dim=1)      # (B,)

            onehot = torch.nn.functional.one_hot(pick, W).bool()              # (B, W)
            pick_tok = ctok_c[b_idx, pick]                                    # (B, NC, M)
            pick_len = clen_c[b_idx, pick]                                    # (B, NC)
            wt2 = torch.where(onehot[:, None, :, None], pick_tok[:, :, None, :],
                              wt[:, None])                                    # (B, NC, W, M)
            wl2 = torch.where(onehot[:, None, :], pick_len[:, :, None], wl[:, None])
            cids, cmasks = build_sequences(wt2.reshape(Bc * NC, W, M),
                                           wl2.reshape(Bc * NC, W), Ts, **ids_of)
            with torch.no_grad():
                scores = base.score_pass(img_c, cids.reshape(Bc, NC, Ts),
                                         cmasks.reshape(Bc, NC, Ts), extras_c, aux, mats)
            stats["score_forwards"] += -(-NC // base.score_chunk(Bc, NC))
            valid = cval_c[b_idx, pick] & has_pick[:, None]
            scores = torch.where(valid, scores.float(), _NEG)
            best = torch.argmax(scores, dim=1)                                # (B,)
            improved = (scores[b_idx, best] > per_loss) & has_pick

            if self.record is not None:
                self.record.append({k: v.detach().cpu() for k, v in dict(
                    rows=rows, sal=torch.where(eligible, sal, _NEG), pick=pick,
                    scores=scores, per_loss=per_loss, best=best, improved=improved).items()})

            commit = improved[:, None] & onehot                               # (B, W)
            new_tok = torch.where(commit[:, :, None], pick_tok[b_idx, best][:, None, :], wt)
            new_len = torch.where(commit, pick_len[b_idx, best][:, None], wl)
            history = history | (onehot & has_pick[:, None])
            n_changed = n_changed + improved.to(torch.int32)
            # the next loop's liveness from the post-commit state: once no
            # sample has an eligible pick, a further loop is a no-op
            live = eligibility(new_len, history, n_changed, att_c).any(dim=1)
            stats["loops"] += 1
            n_live, any_commit = read(live.sum(), improved.any())
            return ((new_tok, new_len, history, n_changed, sal, per_loss, aux,
                     bool(any_commit)), live, n_live)

        def loop(i, state, n_live, floor, live, *ctx):
            while i < max_loops and n_live > floor:
                state, live, n_live = body(state, *ctx)
                i += 1
            return i, state, n_live, live

        history0 = torch.zeros((B, W), dtype=torch.bool, device=dev)
        n0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        live = eligibility(word_len, history0, n0, attackable).any(dim=1)
        n_live, = read(live.sum())
        state = (word_tok, word_len, history0, n0,
                 torch.zeros((B, W), dtype=torch.float32, device=dev),
                 torch.zeros((B,), dtype=torch.float32, device=dev), None, True)

        # live-set compaction (cfg.greedy_compact_frac): once the live count
        # fits in ceil(frac * B) rows, the remaining loops run on the
        # gathered live rows, in a cascade of two stages ceil(B * frac^k)
        # (B = 16, frac = 0.5: 8, then 4), and scatter back.  Exact for a
        # per-sample-independent loss; the JAX package caps the cascade at
        # two stages, and so does the port.
        frac = float(getattr(base.cfg, "greedy_compact_frac", 0.0))
        Bc = int(np.ceil(B * frac)) if frac > 0 else 0
        compactable = (0 < Bc < B and base.per_sample_independent
                       and base.compact_extras(extras, torch.arange(1, device=dev)) is not None)
        stages: List[int] = []
        if compactable:
            k = 1
            while True:
                bc = int(np.ceil(B * frac ** k))
                if not stages or bc < stages[-1]:
                    stages.append(bc)
                if bc <= 1 or len(stages) >= 2:
                    break
                k += 1
        ctx = (torch.arange(B, device=dev), img, extras, attackable, cand_tok, cand_len,
               cand_valid)
        i, state, n_live, live = loop(0, state, n_live, stages[0] if stages else 0,
                                      live, *ctx)
        for s_i, bc in enumerate(stages):
            floor_next = stages[s_i + 1] if s_i + 1 < len(stages) else 0
            if not (i < max_loops and n_live > floor_next):
                continue                # the stage would run no loop
            # stable sort: the live rows first, then the top bc (on the device)
            idx = torch.argsort(torch.where(live, 0, 1).to(torch.int32), stable=True)[:bc]
            sub = tuple(None if t is None else t[idx] for t in state[:7]) + state[7:]
            ctx_c = (idx, {k_: v[idx] for k_, v in img.items()},
                     base.compact_extras(extras, idx), attackable[idx], cand_tok[idx],
                     cand_len[idx], cand_valid[idx])
            i, sub, n_live, live_c = loop(i, sub, n_live, floor_next, live[idx], *ctx_c)
            state = tuple(None if t is None else t.index_copy(0, idx, part)
                          for t, part in zip(state[:7], sub[:7])) + sub[7:]
            live = torch.zeros_like(live).index_copy(0, idx, live_c)

        ids, masks = build_sequences(state[0], state[1], T, **ids_of)
        return ids, masks, state[3]

    # -------------------------------------------------------------- main
    def adv_attack_samples(self, batch: Dict[str, Any], extras) -> Dict[str, Any]:
        """``batch``: tensors on the model's device.  Returns the host-side
        result dict of GreedyAttack.adv_attack_samples."""
        ids0 = batch["text_ids"].cpu().numpy()
        (word_tok, word_len, attackable, cand_tok, cand_len, cand_valid,
         nw, _, _, Ts) = self._prep(ids0)
        dev = batch["text_ids"].device
        tables = [torch.from_numpy(t).to(dev) for t in
                  (word_tok, word_len, attackable, cand_tok, cand_len, cand_valid)]
        ids, masks, n_changed = self._attack(
            batch, extras, *tables, torch.zeros((ids0.shape[0], Ts), dtype=torch.int8))
        ids, masks, n_changed = ids.cpu().numpy(), masks.cpu().numpy(), n_changed.cpu().numpy()
        change_rate = n_changed / np.maximum(nw, 1)
        tok = self.base.tokenizer
        return {
            "txt_input_ids": ids,
            "text_masks": masks,
            "text": [tok.decode(row, skip_special_tokens=True) for row in ids],
            "num_changes": float(n_changed.mean()),
            "change_rate": float(change_rate.mean()),
            "Problem": bool((n_changed == 0).any()),
            "changes_verification": [int(c) for c in n_changed],
        }
