"""Gradient-guided greedy word-substitution attack, host orchestrator (port of
``rmcl_tpu/attacks/greedy.py``: ``check_word``, ``SynonymTable``,
``WordnetSynonyms``, ``GreedyAttack`` and the attackers of the five
frameworks: ``GreedyAttackMoco``, ``GreedyAttackBarlowTwins``,
``GreedyAttackNlvr2``, ``GreedyAttackVqa`` and ``GreedyAttackIrtr``; and
``GreedyAttackNlvr2CrossEntropy``, which scores candidates to first order).

Behavioural spec: reference attack/greedy_attack_vilt.py.  Per batch, per
loop (<= max_loops):
  1. the gradient of the framework loss with respect to the word embeddings
     -> word saliency (L1 norm of the mean sub-token gradient)     [device]
  2. pick the highest-saliency replaceable word per sentence (skip stop and
     function words, punctuation and history; <= 20% of the words and
     <= max_loops changes per sentence)                             [host]
  3. expand each sentence into n_candidates synonym substitutions from the
     counter-fitted embedding neighbourhood                        [host]
  4. score every candidate in one batched forward; commit the best one if
     it raises the sample's loss above its current value           [device]

As in the JAX package: no copy of the model (the parameters are frozen for
the attack's duration, ``attacks/pgd.py:_frozen``), per-sample losses in
place of the reference's substitute-one-row-and-recompute loop, and a
synonym table from chunked products rather than the |V|^2 cosine matrix.

The device work is two plain methods, ``grad_pass`` and ``score_pass``.  The
saliency pass differentiates a deterministic forward through the block ops'
dx-only backwards (``attn_half_dx`` / ``mlp_half_dx`` on the card); the
scoring forward runs under ``no_grad``, so the ops keep nothing for a
backward.  The image side does not change during an attack: its embedding
is computed once per attack (``image_side``; NLVR2's two images each) and
repeated for the candidate rows.  ``attacks/greedy_fused.py`` runs the whole loop on the device.
"""

from __future__ import annotations

import hashlib
import os
import string
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rmcl_tpu_torch.attacks.pgd import _frozen
from rmcl_tpu_torch.core.config import active_tasks
from rmcl_tpu_torch.objectives.contrastive import (_infonce_rows, bt_correlation_loss,
                                                   momentum_update)
from rmcl_tpu_torch.objectives.downstream import irtr_text_panel
from rmcl_tpu_torch.objectives.losses import l2_normalize
from rmcl_tpu_torch.parallel.dist import gather_rows, local_rows

# English function words that are never substitution targets — same role
# as the reference's stopword/filter_words union (greedy_attack_vilt.py:20-46).
STOPWORDS = set("""
a about above across after again against ain all almost alone along already
also although am among amongst an and another any anyhow anyone anything
anyway anywhere are aren around as at back be because been before beforehand
behind being below beside besides between beyond both but by can cannot could
couldn did didn do does doesn doing don down due during each either else
elsewhere empty enough even ever every everyone everything everywhere except
few first for former formerly from further had hadn has hasn have haven he
hence her here hereafter hereby herein hereupon hers herself him himself his
how however hundred i if in indeed into is isn it its itself just latter
latterly least ll may me meanwhile might mightn mine more moreover most mostly
must mustn my myself namely needn neither never nevertheless next no nobody
none noone nor not nothing now nowhere o of off on once one only onto or
other others otherwise our ours ourselves out over per please s same shan she
should shouldn so some somehow something sometime somewhere such t than that
the their theirs them themselves then thence there thereafter thereby
therefore therein thereupon these they this those through throughout thru thus
to too toward towards under unless until up upon used ve very was wasn we were
weren what whatever when whence whenever where whereafter whereas whereby
wherein whereupon wherever whether which while whither who whoever whole whom
whose why will with within without won would wouldn y yet you your yours
yourself yourselves
""".split())

SPECIAL = {"[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"}

GREEDY_FRAMEWORKS = ("moco", "barlowtwins", "nlvr2_attacked",
                     "vqa_attacked", "irtr_attacked")


def greedy_attack_framework(cfg) -> Optional[str]:
    """The first active task that has a greedy attack framework, or None."""
    tasks = active_tasks(cfg)
    return next((t for t in GREEDY_FRAMEWORKS if t in tasks), None)


def check_word(word: str) -> bool:
    """True if the word must not be attacked."""
    raw = word.strip()
    w = raw.lower()
    return (raw in SPECIAL or raw.upper() in SPECIAL or w in STOPWORDS
            or w in string.punctuation or w in "..." or w == "")


# ---------------------------------------------------------------------
class SynonymTable:
    """Counter-fitted-vector cosine neighbourhoods
    (reference greedy_attack_vilt.py:76-111).

    Builds word -> top-n_candidates synonyms with cosine >= sim_thred.  The
    neighbour search runs as chunked products and ``torch.topk`` on
    ``device`` rather than a dense |V| x |V| matrix.  The cache is the JAX
    package's ``np.save`` dict (ids, sims, k, vocab_hash), so a cache written
    by either package loads in the other.
    """

    def __init__(self, embedding_path: str, n_candidates: int,
                 sim_thred: float, cache_path: Optional[str] = None,
                 chunk: int = 2048, device="cpu"):
        self.n_candidates = n_candidates
        self.sim_thred = sim_thred
        self.word2id: Dict[str, int] = {}
        self.id2word: Dict[int, str] = {}

        vecs: List[np.ndarray] = []
        with open(embedding_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split()
                if len(parts) < 3:
                    continue
                w = parts[0]
                if w in self.word2id:
                    continue
                self.word2id[w] = len(self.word2id)
                self.id2word[len(self.id2word)] = w
                vecs.append(np.asarray(parts[1:], np.float32))
        emb = np.stack(vecs)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)

        # a stored k rejects a cache built for a smaller n_candidates, and
        # the vocabulary fingerprint one built from another embedding file
        # at the same (relative, shared) path
        vocab_hash = hashlib.sha256(
            "\n".join(self.id2word[i] for i in range(len(self.id2word)))
            .encode()).hexdigest()
        k_eff = min(n_candidates + 1, emb.shape[0])  # top-k caps at |V|
        if cache_path and not cache_path.endswith(".npy"):
            cache_path = cache_path + ".npy"
        data = None
        if cache_path and os.path.exists(cache_path):
            data = np.load(cache_path, allow_pickle=True).item()
            if (data.get("k", 0) < k_eff
                    or data.get("vocab_hash") != vocab_hash):
                data = None             # stale/foreign cache: rebuild
        if data is not None:
            self.nbr_ids, self.nbr_sims = data["ids"], data["sims"]
        else:
            self.nbr_ids, self.nbr_sims = self._topk_chunked(
                emb, k_eff, chunk, device)
            if cache_path:
                np.save(cache_path, {"ids": self.nbr_ids,
                                     "sims": self.nbr_sims,
                                     "k": k_eff,
                                     "vocab_hash": vocab_hash})

        self.table: Dict[int, List[str]] = {}
        for idx in range(len(self.word2id)):
            cands: List[str] = []
            for j, s in zip(self.nbr_ids[idx], self.nbr_sims[idx]):
                if s < self.sim_thred:
                    break
                if int(j) == idx:
                    continue
                cands.append(self.id2word[int(j)])
                if len(cands) >= self.n_candidates:
                    break
            self.table[idx] = cands or [self.id2word[idx]]

    @staticmethod
    def _topk_chunked(emb: np.ndarray, k: int, chunk: int, device="cpu"):
        n = emb.shape[0]
        ids = np.zeros((n, k), np.int32)
        sims = np.zeros((n, k), np.float32)
        embt = torch.from_numpy(emb).to(device)
        with torch.no_grad():
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                top = torch.topk(embt[s:e] @ embt.t(), k, dim=1)
                sims[s:e] = top.values.cpu().numpy()
                ids[s:e] = top.indices.cpu().numpy()
        return ids, sims

    def candidates(self, word: str) -> List[str]:
        idx = self.word2id.get(word)
        if idx is None:
            return [word]
        return list(self.table[idx])

    def __contains__(self, word: str) -> bool:
        return word in self.word2id


class WordnetSynonyms:
    """`synonym="synonym"` mode (reference :205-220): WordNet lemmas.
    Gated — nltk's wordnet data may be absent."""

    def __init__(self, n_candidates: int):
        self.n_candidates = n_candidates
        from nltk.corpus import wordnet  # noqa — raises if data missing
        wordnet.synsets("test")
        self._wn = wordnet

    def candidates(self, word: str) -> List[str]:
        cands: List[str] = []
        for syn in self._wn.synsets(word):
            for lemma in syn.lemmas():
                w = lemma.name()
                if check_word(w) or w in cands:
                    continue
                cands.append(w)
        return (cands or [word])[: self.n_candidates]

    def __contains__(self, word: str) -> bool:
        return True


# ---------------------------------------------------------------------
class GreedyAttack:
    """Host orchestrator.  Subclass hooks:
      loss_per_sample(batch, extras, mats, word_embeds) -> (per-sample loss
          (B,), aux for scoring)
      score_candidates(flat_batch, B, nc, extras, aux, mats) -> (B, nc)
    ``batch`` here is the attack's own: ``text_ids``, ``text_masks`` and the
    image side (``image_side``); ``mats`` the query transformer's matrices
    in the compute type (``ViT.block_matrices``)."""

    # loss_per_sample row i depends only on sample i (given batch-shared
    # extras), so the fused attack may gather the still-live samples into a
    # smaller batch mid-loop (greedy_fused.py live-set compaction) and score
    # the candidates in chunks.  Subclasses whose loss couples the batch
    # must set this False.
    per_sample_independent = True
    # the batch's images the attack embeds once (``image_side``)
    image_keys = ("image",)

    def __init__(self, cfg, model, tokenizer, synonyms):
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.synonyms = synonyms
        self.max_length = cfg.max_text_len
        self.n_candidates = cfg.n_candidates
        self.max_loops = cfg.max_loops

    # ------------------------------------------------------ subclass API
    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        """Returns (per_sample_loss (B,), aux for scoring)."""
        raise NotImplementedError

    def tile_extras(self, extras, nc: int):
        """How per-sample extras broadcast to the candidate batch.
        Default: leave unchanged (batch-shared extras)."""
        return extras

    def compact_extras(self, extras, idx):
        """Gather the per-sample leaves of `extras` to the live-sample rows
        `idx` (the compaction twin of tile_extras).  Returning None marks
        the framework as non-compactable."""
        return None

    def score_candidates(self, flat_batch, B: int, nc: int, extras, aux, mats):
        """Default: per-sample loss of the flat candidate forward."""
        per, _ = self.loss_per_sample(flat_batch, self.tile_extras(extras, nc), mats)
        return per.reshape(B, nc)

    # --------------------------------------------------------- device fns
    def infer(self, batch, mats, word_embeds=None, image_token_type_idx: int = 1):
        """The deterministic query forward of an attack batch, on the image
        side of ``image_{idx - 1}`` when the batch has it, else of ``image``
        (``ViLT.infer``'s rule)."""
        key = f"image_{image_token_type_idx - 1}"
        key = key if f"{key}_embeds" in batch else "image"
        return self.model.infer(batch, mats, image_embeds=batch[f"{key}_embeds"],
                                image_masks=batch[f"{key}_masks"],
                                image_token_type_idx=image_token_type_idx,
                                word_embeds=word_embeds)

    def matrices(self, block_matrices=None):
        m = self.model
        return block_matrices or m.transformer.block_matrices(m.compute_dtype)

    @torch.no_grad()
    def image_side(self, batch) -> Dict[str, torch.Tensor]:
        """The image embeddings of a wire-format batch, computed once per
        attack: {"<key>_embeds", "<key>_masks"} for each of ``image_keys``."""
        from rmcl_tpu_torch.models.vit import normalize_u8
        m = self.model
        side = {}
        for key in self.image_keys:
            img = batch[key]
            if img.dtype == torch.uint8:
                img = normalize_u8(img, batch.get(f"{key}_hw"), m.grid_hw, m.patch_size)
            side[f"{key}_embeds"], side[f"{key}_masks"] = m.transformer.visual_embed(
                img, m.grid_hw, m.max_image_len, m.compute_dtype)
        return side

    def grad_pass(self, batch, extras, mats):
        """(per-sample loss (B,), d mean-loss / d word embeddings (B, T, C) in
        fp32, aux).  The caller freezes the parameters for the whole attack
        (``_frozen``; the block ops raise otherwise): the gradient flows to
        the word embeddings only, through the block ops' dx backwards."""
        weight = self.model.text_embeddings.word_embeddings.weight
        we = weight.detach()[batch["text_ids"].long()].requires_grad_(True)
        with torch.enable_grad():
            per, aux = self.loss_per_sample(batch, extras, mats, word_embeds=we)
            grads, = torch.autograd.grad(per.mean(), we)
        return per.detach(), grads.float(), aux

    def score_chunk(self, B: int, nc: int) -> int:
        """Candidates per scoring forward of ``score_pass``."""
        cap = (int(getattr(self.cfg, "greedy_score_max_rows", 0) or 0)
               if self.per_sample_independent else 0)
        return max(1, cap // B) if cap and B * nc > cap else nc

    @torch.no_grad()
    def score_pass(self, batch, cand_ids, cand_masks, extras, aux, mats):
        """(B, nc) candidate scores: the (B * nc)-row forward, chunked along
        the candidate axis when B * nc exceeds ``cfg.greedy_score_max_rows``
        (only for per-sample-independent frameworks, whose rows do not
        depend on the other rows of the scoring batch)."""
        B, nc, T = cand_ids.shape
        ncg = self.score_chunk(B, nc)
        scores = []
        for j in range(0, nc, ncg):
            n = min(ncg, nc - j)
            flat = {k: batch[k].repeat_interleave(n, dim=0) for k in batch
                    if not k.startswith("text_")}
            flat["text_ids"] = cand_ids[:, j:j + n].reshape(B * n, T)
            flat["text_masks"] = cand_masks[:, j:j + n].reshape(B * n, T)
            scores.append(self.score_candidates(flat, B, n, extras, aux, mats))
        return torch.cat(scores, dim=1)

    # ----------------------------------------------------------- helpers
    def _words_to_sub_words(self, words: List[str]) -> Dict[int, np.ndarray]:
        mapping: Dict[int, np.ndarray] = {}
        pos = 0
        for idx, w in enumerate(words):
            ln = len(self.tokenizer.tokenize(w))
            if pos + ln >= self.max_length:
                break
            mapping[idx] = np.arange(pos, pos + ln)
            pos += ln
        return mapping

    def _saliency(self, grads_i: np.ndarray, mapping) -> List[float]:
        scores = []
        for idx in range(len(mapping)):
            toks = mapping[idx]
            agg = grads_i[toks].mean(axis=0)
            scores.append(float(np.linalg.norm(agg, ord=1)))
        return scores

    def _pick_word(self, words, saliency, mapping, history, n_changed,
                   text_len) -> Optional[int]:
        order = np.argsort(saliency)[::-1]
        # 20%-of-words budget measured at the SEP token INDEX — i.e.
        # 1 (CLS) + n_subtokens, one less than the mask sum (reference
        # greedy_attack_vilt.py:277,288 `int(sep_idx[i][1] * 0.2)`)
        max_changes = min(int((text_len - 1) * 0.2), self.max_loops)
        for idx in order:
            idx = int(idx)
            w = words[idx].strip().lower()
            if check_word(w):
                continue
            if w not in self.synonyms:
                continue
            if idx in history:
                continue
            if n_changed >= max_changes:
                continue
            return idx
        return None

    # -------------------------------------------------------------- main
    def adv_attack_samples(self, batch: Dict[str, Any], extras,
                           block_matrices=None) -> Dict[str, Any]:
        """``batch``: tensors on the model's device (``image``, ``text_ids``,
        ``text_masks``); the text side is attacked.  Returns the reference's
        result dict (txt_input_ids, text_masks, text, num_changes,
        change_rate, ...) on the host."""
        with _frozen(self.model):
            return self._attack(batch, extras, block_matrices)

    def _attack(self, batch, extras, block_matrices):
        tok = self.tokenizer
        dev = batch["text_ids"].device
        mats = self.matrices(block_matrices)
        ids0 = batch["text_ids"].cpu().numpy()
        B = ids0.shape[0]
        original_words = [tok.decode(ids, skip_special_tokens=True).split(" ")
                          for ids in ids0]
        cur_words = [list(w) for w in original_words]
        mappings = [self._words_to_sub_words(w) for w in cur_words]
        history: List[set] = [set() for _ in range(B)]
        n_changed = [0] * B
        cur = dict(self.image_side(batch), text_ids=batch["text_ids"],
                   text_masks=batch["text_masks"])

        for _ in range(self.max_loops):
            per_loss, grads, aux = self.grad_pass(cur, extras, mats)
            per_loss = per_loss.float().cpu().numpy()
            grads = grads.cpu().numpy()
            text_lens = cur["text_masks"].sum(dim=1).cpu().numpy()

            picks: List[Optional[int]] = []
            for i in range(B):
                sal = self._saliency(grads[i][1:], mappings[i])
                if not sal:
                    picks.append(None)
                    continue
                picks.append(self._pick_word(
                    cur_words[i], sal, mappings[i], history[i],
                    n_changed[i], int(text_lens[i])))

            # candidate sentences, padded to exactly n_candidates
            nc = self.n_candidates
            cand_texts: List[List[str]] = []
            cand_valid = np.zeros((B, nc), bool)
            for i in range(B):
                row: List[str] = []
                if picks[i] is not None:
                    history[i].add(picks[i])
                    cands = self.synonyms.candidates(
                        cur_words[i][picks[i]].strip().lower())
                    for j, new_word in enumerate(cands[:nc]):
                        w = list(cur_words[i])
                        w[picks[i]] = new_word
                        row.append(" ".join(w))
                        cand_valid[i, j] = new_word != cur_words[i][picks[i]]
                base = " ".join(cur_words[i])
                while len(row) < nc:
                    row.append(base)
                cand_texts.append(row)

            flat_texts = [t for row in cand_texts for t in row]
            cand_ids, cand_masks = tok.batch_encode(flat_texts, self.max_length)
            shape = (B, nc, self.max_length)
            scores = self.score_pass(
                cur, torch.from_numpy(cand_ids.reshape(shape)).to(dev),
                torch.from_numpy(cand_masks.reshape(shape)).to(dev), extras, aux, mats)
            scores = np.where(cand_valid, scores.float().cpu().numpy(), -np.inf)

            best = scores.argmax(axis=1)
            improved = scores[np.arange(B), best] > per_loss

            for i in range(B):
                if picks[i] is None or not improved[i]:
                    continue
                cur_words[i] = cand_texts[i][int(best[i])].split(" ")
                mappings[i] = self._words_to_sub_words(cur_words[i])
                n_changed[i] += 1

            texts = [" ".join(w) for w in cur_words]
            new_ids, new_masks = tok.batch_encode(texts, self.max_length)
            cur = dict(cur, text_ids=torch.from_numpy(new_ids).to(dev),
                       text_masks=torch.from_numpy(new_masks).to(dev))

        num_changes, change_rate = [], []
        for old, new in zip(original_words, cur_words):
            ch = sum(o != n for o, n in zip(old, new))
            num_changes.append(ch)
            change_rate.append(ch / max(len(old), 1))

        return {
            "txt_input_ids": cur["text_ids"].cpu().numpy(),
            "text_masks": cur["text_masks"].cpu().numpy(),
            "text": [" ".join(w) for w in cur_words],
            "num_changes": float(np.mean(num_changes)),
            "change_rate": float(np.mean(change_rate)),
            "Problem": any(c == 0 for c in num_changes),
            "changes_verification": n_changed,
        }


# ------------------------------------------------------- framework losses
class GreedyAttackMoco(GreedyAttack):
    """InfoNCE loss per sample (reference GreedyAttack_moco :385-599).
    extras = (k_modality (B, 128), neg_queue (128, K), temperature)."""

    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        k_modality, neg_queue, temperature = extras
        infer = self.infer(batch, mats, word_embeds)
        q = l2_normalize(self.model.moco_head(infer["cls_feats"]), dim=1).float()
        l_pos = (q * k_modality.float()).sum(-1, keepdim=True)
        l_neg = q @ neg_queue.float()
        logits = torch.cat([l_pos, l_neg], dim=1) / temperature
        return _infonce_rows(logits), None

    def tile_extras(self, extras, nc):
        k_modality, neg_queue, temperature = extras
        return (k_modality.repeat_interleave(nc, dim=0), neg_queue, temperature)

    def compact_extras(self, extras, idx):
        k_modality, neg_queue, temperature = extras
        return (k_modality[idx], neg_queue, temperature)


class GreedyAttackBarlowTwins(GreedyAttack):
    """BarlowTwins scoring by an exact rank-1 update of the correlation
    matrix (the reference, GreedyAttack_barlowtwins :602-832, substitutes
    each candidate's projection into the batch and recomputes the 8192 x 8192
    correlation).  Substituting row i changes c = q^T k / psb by
    outer(q_new_i - q_old_i, k_i) / psb, so each candidate's loss follows in
    O(D) from terms of the batch.  The head's BatchNorms run in training mode
    (batch statistics: the gradient pass's over B rows, the scoring
    forward's over B * nc) and their running statistics stay as they are.
    extras = (k (B, D), per_step_bs, lam).

    Over several processes the batch is the global one, as the JAX
    package's pjit step sees it: ``k`` and the gradient pass's projections
    hold every rank's rows, both head calls read every rank's class features
    (``parallel/dist.py:gather_rows``), and each rank scores the candidates
    of its own rows against the global terms; the fused loop agrees its exit
    across ranks (``greedy_fused.py``)."""

    per_sample_independent = False  # the correlation loss couples the batch

    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        k, psb, lam = extras
        cls = self.infer(batch, mats, word_embeds)["cls_feats"]
        q = self.model.barlowtwins_head(gather_rows(cls), training=True)
        loss, _, _ = bt_correlation_loss(q, k, psb, lam)
        # the batch loss for every sample: the word-embedding gradient still
        # tells the words of each sentence apart, which is all the pick needs
        return loss.expand(cls.shape[0]), q.detach()

    def score_candidates(self, flat_batch, B: int, nc: int, extras, aux, mats):
        k, psb, lam = extras
        infer = self.infer(flat_batch, mats)
        q_cand = local_rows(self.model.barlowtwins_head(gather_rows(infer["cls_feats"]),
                                                        training=True))
        D = aux.shape[1]
        q_cand = q_cand.reshape(B, nc, D).float()
        q32, k32 = aux.float(), k.float()               # aux: q of the gradient pass
        qi, v = local_rows(q32), local_rows(k32)         # this rank's rows of the batch
        # the batch terms: diag(c), ||c||^2 and c v_i, from (B, B) Grams when
        # B < D (bt_correlation_loss's algebra), from c itself when B >= D
        Bg = q32.shape[0]
        if Bg >= D:
            c = q32.t() @ k32 / psb                      # (D, D)
            diag_c = torch.diagonal(c)
            sum_sq = (c ** 2).sum()
        else:
            diag_c = (q32 * k32).sum(0) / psb            # (D,)
            sum_sq = ((q32 @ q32.t()) * (k32 @ k32.t())).sum() / (psb * psb)
        sum_diag_sq = (diag_c ** 2).sum()
        on_base = ((diag_c - 1.0) ** 2).sum()
        # candidate (i, j): c' = c + u v^T with u = (q_cand - q_i) / psb, v = k_i
        u = (q_cand - qi[:, None, :]) / psb              # (B, nc, D)
        # ||c'||^2 = ||c||^2 + 2 u.(c v) + ||u||^2 ||v||^2
        cvi = v @ c.t() if Bg >= D else ((v @ k32.t()) @ q32) / psb  # (B, D) = c v_i
        dot_ucv = torch.einsum("bnd,bd->bn", u, cvi)
        norm2 = (u ** 2).sum(-1) * (v ** 2).sum(-1)[:, None]
        sum_sq_new = sum_sq + 2 * dot_ucv + norm2
        # diag(c') = diag(c) + u * v elementwise
        uv = u * v[:, None, :]                           # (B, nc, D)
        uv_sq = (uv ** 2).sum(-1)
        diag_new_sq = sum_diag_sq + 2 * torch.einsum("bnd,d->bn", uv, diag_c) + uv_sq
        on_new = on_base + 2 * torch.einsum("bnd,d->bn", uv, diag_c - 1.0) + uv_sq
        return on_new + lam * (sum_sq_new - diag_new_sq)


class GreedyAttackNlvr2(GreedyAttack):
    """Per-sample CE of the two-image pass (reference GreedyAttack_nlvr2
    :835-1042).  extras = (labels (B,),)."""

    image_keys = ("image_0", "image_1")

    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        (labels,) = extras
        cls = [self.infer(batch, mats, word_embeds, i)["cls_feats"] for i in (1, 2)]
        logits = self.model.nlvr2_classifier(torch.cat(cls, dim=-1))
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels.long()[:, None])[:, 0], None

    def tile_extras(self, extras, nc):
        (labels,) = extras
        return (labels.repeat_interleave(nc, dim=0),)

    def compact_extras(self, extras, idx):
        (labels,) = extras
        return (labels[idx],)


class GreedyAttackVqa(GreedyAttack):
    """Per-sample BCE x label_size (reference GreedyAttack_vqa :1263-1478).
    extras = (vqa_targets (B, label_size),)."""

    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        (targets,) = extras
        logits = self.model.vqa_classifier(
            self.infer(batch, mats, word_embeds)["cls_feats"]).float()
        t = targets.float()
        per = logits.clamp(min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
        return per.mean(dim=1) * targets.shape[1], None

    def tile_extras(self, extras, nc):
        (targets,) = extras
        return (targets.repeat_interleave(nc, dim=0),)

    def compact_extras(self, extras, idx):
        (targets,) = extras
        return (targets[idx],)


class GreedyAttackIrtr(GreedyAttack):
    """The JAX package's repaired IRTR attacker (the reference's,
    GreedyAttack_irtr :1045-1260, reads undefined state): InfoNCE of each
    joint projection against the in-batch text projections.
    extras = (text_repr (N, 128), temperature, sample_ids (B,)): the panel
    of texts (N the global batch in a training step over several processes)
    and each pair's own row in it."""

    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        text_repr, temperature, sample_ids = extras
        cls = self.infer(batch, mats, word_embeds)["cls_feats"]
        q = l2_normalize(self.model.moco_head(cls), dim=1).float()
        logp = torch.log_softmax(q @ text_repr.float().t() / temperature, dim=-1)
        return -logp.gather(1, sample_ids.long()[:, None])[:, 0], None

    def tile_extras(self, extras, nc):
        text_repr, temperature, sample_ids = extras
        return (text_repr, temperature, sample_ids.repeat_interleave(nc, dim=0))

    def compact_extras(self, extras, idx):
        # the panel stays whole: sample i's loss reads its own row against
        # all B text projections
        text_repr, temperature, sample_ids = extras
        return (text_repr, temperature, sample_ids[idx])


class GreedyAttackNlvr2CrossEntropy(GreedyAttack):
    """Geometric-scored NLVR2 greedy attack (reference
    Geometric_attack/greedy_attack_vilt_cross_entropy.py:418-447): candidates
    are ranked by the first-order loss increase, the projection of the
    representation's change onto the loss gradient, score = per +
    (cls(cand) - cls(orig)) . dL/dcls, instead of the loss of a full head
    pass.  One gradient at the joint representation replaces a per-candidate
    loss.  extras = (labels (B,),).  No configuration selects it, as in the
    JAX package (``GREEDY_ATTACKERS`` holds the per-framework attackers)."""

    image_keys = ("image_0", "image_1")

    def _head_loss(self, cls, labels):
        logits = self.model.nlvr2_classifier(cls)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels.long()[:, None])[:, 0]

    def _cls(self, batch, mats, word_embeds=None):
        return torch.cat([self.infer(batch, mats, word_embeds, i)["cls_feats"]
                          for i in (1, 2)], dim=-1)

    def _cls_and_grad(self, batch, labels, mats, word_embeds=None):
        """(cls (B, 2C), d sum(per) / d cls, per (B,)): the two
        ``image_token_type_idx`` forwards, the gradient of the summed head
        loss with respect to ``cls`` only; ``per`` keeps its graph to the
        word embeddings."""
        cls = self._cls(batch, mats, word_embeds)
        c = cls.detach().requires_grad_(True)
        with torch.enable_grad():
            grad_cls, = torch.autograd.grad(self._head_loss(c, labels).sum(), c)
        return cls, grad_cls, self._head_loss(cls, labels)

    def loss_per_sample(self, batch, extras, mats, word_embeds=None):
        (labels,) = extras
        cls, grad_cls, per = self._cls_and_grad(batch, labels, mats, word_embeds)
        # aux: what score_candidates needs, the base loss included, so that the
        # first-order score compares against the commit rule
        return per, (cls.detach(), grad_cls.detach(), per.detach())

    def tile_extras(self, extras, nc):
        (labels,) = extras
        return (labels.repeat_interleave(nc, dim=0),)

    def compact_extras(self, extras, idx):
        (labels,) = extras
        return (labels[idx],)

    def score_candidates(self, flat_batch, B: int, nc: int, extras, aux, mats):
        cls_orig, grad_cls, per = aux                    # (B, 2C), (B, 2C), (B,)
        cls_cand = self._cls(flat_batch, mats).reshape(B, nc, -1)
        delta = cls_cand.float() - cls_orig[:, None].float()
        first_order = torch.einsum("bnd,bd->bn", delta, grad_cls.float())
        # the estimated candidate loss: the current loss + the first-order
        # change; the commit rule keeps a candidate iff it beats the loss
        return per[:, None] + first_order


# each framework's attacker (GreedyAttackNlvr2CrossEntropy, which no
# configuration selects, is not among them, as in the JAX package)
GREEDY_ATTACKERS = {"moco": GreedyAttackMoco, "barlowtwins": GreedyAttackBarlowTwins,
                    "nlvr2_attacked": GreedyAttackNlvr2, "vqa_attacked": GreedyAttackVqa,
                    "irtr_attacked": GreedyAttackIrtr}


@torch.no_grad()
def greedy_attack_extras(cfg, model, framework: str, batch, block_matrices=None):
    """The attacker's extras, with no lasting effect on the model.

    moco: the post-EMA key projection and the queue, (k, queue,
    temperature).  The reference runs the attack after the momentum update
    (objectives.py:256-265, then :277-285), so the keys come from the
    updated twins; the twins are updated in place for the key forward and
    restored after it.  barlowtwins: (k, B, adv_lr), k the head's
    training-mode projection of the deterministic forward of the global
    batch (every rank's rows), its BatchNorm running statistics left as they
    are.  The attacked step (``train/step.py``) takes the step's own keys
    instead and runs no second key forward.  nlvr2_attacked:
    (labels,); vqa_attacked: (vqa_targets,); irtr_attacked: (text_repr,
    temperature, sample_ids), text_repr the normalised MoCo projections of
    the deterministic forward of the global batch (every rank's rows,
    ``objectives/downstream.py:irtr_text_panel``) and sample_ids this rank's
    rows among them (``block_matrices``: the transformer's matrices in the
    compute type, else cast here)."""
    if framework == "nlvr2_attacked":
        return (batch["answers"].long(),)
    if framework == "vqa_attacked":
        return (batch["vqa_targets"],)
    if framework == "irtr_attacked":     # every rank's texts: the global batch's panel
        text_repr, row0 = irtr_text_panel(model, batch, block_matrices)
        b = batch["text_ids"].shape[0]
        return (text_repr, cfg.temperature,
                torch.arange(row0, row0 + b, device=text_repr.device))
    if framework == "barlowtwins":       # every rank's rows: the global batch's key
        k = model.barlowtwins_head(gather_rows(model.infer(batch)["cls_feats"]),
                                   training=True)
        return (k, k.shape[0], cfg.adv_lr)
    twins = [p for name, p in model.named_parameters() if name.startswith("k_")]
    saved = [p.detach().clone() for p in twins]
    try:
        momentum_update(model, cfg.momentum)
        infer_k = model.infer_k(batch)
        k = l2_normalize(model.k_moco_head(infer_k["cls_feats"]), dim=1)
    finally:
        for p, s in zip(twins, saved):
            p.copy_(s)
    return (k, model.proj_queue.detach().clone(), cfg.temperature)
