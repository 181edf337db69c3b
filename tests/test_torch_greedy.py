"""The port's greedy word-substitution attack (rmcl_tpu_torch/attacks/greedy.py,
greedy_fused.py), its extras (train/loop.py) and the attacked task_moco step
(train/step.py:make_attacked_train_step) against the JAX package, on the CPU
in fp32 at the size of tests/test_attacks.py (hidden 32, 2 layers, 2 heads,
max_text_len 12, n_candidates 3, max_loops 2, drop_rate 0), with the same
vocabulary file, counter-fitted vectors, weights, images and keys.

Token ids and change counts are held exactly: the attack's decisions are
argmaxes and strict comparisons of fp32 values that the two packages compute
within rounding of each other, and no decision here is that close.  The
attacked step: loss within rtol 1e-5, the updated leaves, twins and queue
as tests/test_torch_train.py:test_two_moco_steps_match_jax holds them.

The fuzz case and one text-bucket case use a second vocabulary in which
words split into several sub-tokens.

The JAX package compiles each attack program on first use, which is most of
this file's time: one host attacker and one fused attacker of the JAX package
serve every case that uses the 12-token model, the attacked step's case
takes its attacked ids from that host attacker, and the JAX package's plain
functions run jitted."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import greedy_fused as JF
from rmcl_tpu.core.config import build_config, loss_names
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.heads import moco_head
from rmcl_tpu.models.vilt import ViLTModel
from rmcl_tpu.objectives.losses import l2_normalize
from rmcl_tpu.train import loop as JL
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.attacks import greedy as TG
from rmcl_tpu_torch.attacks import greedy_fused as TF
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.train import loop as TL
from rmcl_tpu_torch.train import step as TT
from tests.conftest import make_fake_batch
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests._torch_threads import one_thread  # noqa: F401

SENTENCES = {   # the batches of tests/test_attacks.py
    "end_to_end": ["dog runs in park", "cat sits in street"],
    "four": ["dog runs in park", "cat sits in street", "big red car on road",
             "the a on in"],
    "compaction": ["big red car on road near park", "the a on in", "dog runs",
                   "cat sits"],
}


def _cfg(**kw):
    base = dict(
        hidden_size=32, num_heads=2, num_layers=2, patch_size=16, image_size=32,
        image_bucket_hw=(32, 48), max_text_len=12, loss_names=loss_names({"moco": 1}),
        num_negative=16, temperature=0.07, n_candidates=3, max_loops=2,
        use_pallas_attention=False, compute_dtype="float32", drop_rate=0.0)
    base.update(kw)
    return build_config(**base)


def _write_vectors(path, groups, words):
    """Counter-fitted style vectors: the words of a group share a direction
    (tests/test_attacks.py's tiny_synonyms)."""
    rng = np.random.RandomState(0)
    vecs = {}
    for group in groups:
        base = rng.randn(16)
        for w in group:
            vecs[w] = base + 0.05 * rng.randn(16)
    for w in words:
        if w not in vecs:
            vecs[w] = rng.randn(16)
    with open(path, "w") as f:
        for w, v in vecs.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The vocabulary and vectors of tests/test_attacks.py's fixtures."""
    d = tmp_path_factory.mktemp("greedy")
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    return vocab, _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)


class Side:
    """One package's tokenizer, synonyms and model."""

    def __init__(self, tok, syn, cfg, model, params=None):
        self.tok, self.syn, self.cfg, self.model, self.params = tok, syn, cfg, model, params


@pytest.fixture(scope="module")
def sides(files):
    """(jax, port) at max_text_len 12 on the same weights, and the JAX
    package's host and fused attackers, made once (their programs compile
    on first use)."""
    j, t = _jax_side(*files)
    # without compaction: one loop body to compile (its compaction is exact,
    # tests/test_attacks.py :271; the port's is held to it below)
    j.fused = JF.FusedGreedyAttack(JG.GreedyAttackMoco(
        j.cfg.replace(greedy_compact_frac=0.0), j.model, j.tok, j.syn))
    return j, t


def _keys_fn(jmodel):
    """The JAX package's deterministic key projection, jitted."""
    @jax.jit
    def keys(params, batch):
        infer_k = jmodel.infer_k(params, batch, deterministic=True)
        return l2_normalize(moco_head(params["k_moco_head"], infer_k["cls_feats"]), 1)
    return keys


def _batch(cfg, tok, sentences, seed=0):
    ids, masks = tok.batch_encode(sentences, cfg.max_text_len)
    img = make_fake_batch(cfg, batch=len(sentences), seed=seed)["image"]
    return {"image": hwc_to_patch_rows(img, cfg.patch_size),
            "text_ids": ids.astype(np.int32), "text_masks": masks.astype(np.int32)}


def _extras(j, batch):
    """The JAX package's keys and queue (numpy), which both packages use."""
    k = j.keys(j.params, {key: jnp.asarray(v) for key, v in batch.items()})
    return np.asarray(k), np.asarray(j.state["proj_queue"])


def _jax_run(attacker, j, batch, extras):
    k, queue = extras
    return attacker.adv_attack_samples(j.params, batch,
                                       (jnp.asarray(k), jnp.asarray(queue), j.cfg.temperature))


def _port_run(attacker, batch, extras, temperature=0.07):
    k, queue = extras
    tb = {key: torch.from_numpy(v) for key, v in batch.items()}
    return attacker.adv_attack_samples(tb, (torch.tensor(k), torch.tensor(queue), temperature))


def _port_fused(t, **kw):
    cfg = t.cfg.replace(**kw)
    return TF.FusedGreedyAttack(TG.GreedyAttackMoco(cfg, t.model, t.tok, t.syn))


def _same(ours, ref, what):
    np.testing.assert_array_equal(ours["txt_input_ids"], ref["txt_input_ids"], err_msg=what)
    np.testing.assert_array_equal(ours["text_masks"], ref["text_masks"], err_msg=what)
    assert ours["changes_verification"] == ref["changes_verification"], what
    assert ours["num_changes"] == ref["num_changes"], what
    assert abs(ours["change_rate"] - ref["change_rate"]) < 1e-9, what


@pytest.fixture(scope="module")
def four(sides):
    """The four-sentence batch of test_fused_greedy_matches_host: its batch,
    keys, and the JAX package's host and fused results."""
    j, _ = sides
    batch = _batch(j.cfg, j.tok, SENTENCES["four"])
    extras = _extras(j, batch)
    return batch, extras, _jax_run(j.host, j, batch, extras), _jax_run(j.fused, j, batch, extras)


# ------------------------------------------------------------- host copies
@pytest.mark.parametrize("T,B,W,M,seed,truncates", [
    (12, 5, 8, 4, 0, True), (40, 4, 12, 4, 1, False), (8, 6, 6, 8, 2, True),
    (16, 3, 16, 2, 3, False)], ids=["truncated", "fits", "short-T", "zero-length-words"])
def test_build_sequences_matches_jax(T, B, W, M, seed, truncates):
    """Random word tables, some with total lengths past T - 2 (truncated as
    tokenizer.encode truncates), some with words of no sub-token: ids and
    masks exactly."""
    r = np.random.RandomState(seed)
    word_tok = r.randint(5, 1000, (B, W, M)).astype(np.int32)
    word_len = r.randint(0 if seed == 3 else 1, M + 1, (B, W)).astype(np.int32)
    word_len[0, W // 2:] = 0                            # one short caption
    ref = jax.jit(JF.build_sequences, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(word_tok), jnp.asarray(word_len), T, 2, 3, 0)
    ours = TF.build_sequences(torch.from_numpy(word_tok), torch.from_numpy(word_len),
                              T, 2, 3, 0)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (word_len.sum(1) > T - 2).any() == truncates


def _vectors(path, n=40, d=12, seed=5):
    r = np.random.RandomState(seed)
    base = r.randn(n // 4, d)
    with open(path, "w") as f:
        for i in range(n):
            v = base[i // 4] + 0.3 * r.randn(d)
            f.write(f"w{i} " + " ".join(f"{x:.5f}" for x in v) + "\n")


def test_synonym_table_matches_jax_and_shares_its_cache(tmp_path, monkeypatch):
    """The same neighbour ids (sims within fp32 rounding) and candidate
    table as the JAX package's, over several chunks; a cache written by
    either package loads in the other without a rebuild."""
    vec = str(tmp_path / "v.txt")
    _vectors(vec)
    ours = TG.SynonymTable(vec, 4, 0.3, chunk=7)
    ref = JG.SynonymTable(vec, 4, 0.3, chunk=7)
    np.testing.assert_array_equal(ours.nbr_ids, ref.nbr_ids)
    np.testing.assert_allclose(ours.nbr_sims, ref.nbr_sims, atol=1e-6)
    assert ours.table == ref.table and ours.word2id == ref.word2id

    def no_rebuild(*a, **k):
        raise AssertionError("the cache was rebuilt")

    for writer, reader, name in ((TG, JG, "port.npy"), (JG, TG, "jax.npy")):
        cache = str(tmp_path / name)
        written = writer.SynonymTable(vec, 4, 0.3, cache_path=cache)
        with monkeypatch.context() as m:
            m.setattr(reader.SynonymTable, "_topk_chunked", staticmethod(no_rebuild))
            loaded = reader.SynonymTable(vec, 4, 0.3, cache_path=cache)
        assert loaded.table == written.table == ref.table
    # a cache for fewer candidates is rebuilt, in the port as in the JAX package
    small = str(tmp_path / "small.npy")
    JG.SynonymTable(vec, 1, 0.3, cache_path=small)
    assert TG.SynonymTable(vec, 4, 0.3, cache_path=small).table == ref.table


def _wordnet_data() -> bool:
    """Whether nltk's wordnet corpus is in one of nltk's default data
    directories (looked up without importing nltk, whose import is slow)."""
    import os
    import sys
    roots = [p for p in os.environ.get("NLTK_DATA", "").split(os.pathsep) if p]
    roots += [os.path.expanduser("~/nltk_data")]
    roots += [os.path.join(sys.prefix, d) for d in ("nltk_data", "share/nltk_data",
                                                   "lib/nltk_data")]
    roots += [f"/usr/{d}/nltk_data" for d in ("share", "local/share", "lib", "local/lib")]
    return any(os.path.exists(os.path.join(r, "corpora", n))
               for r in roots for n in ("wordnet", "wordnet.zip"))


def test_wordnet_synonyms_gated():
    if not _wordnet_data():
        pytest.skip("nltk's wordnet data is not installed")
    pytest.importorskip("nltk")
    ours, ref = TG.WordnetSynonyms(3), JG.WordnetSynonyms(3)
    for w in ("dog", "car", "quickly"):
        assert ours.candidates(w) == ref.candidates(w)


# ------------------------------------------------------------ the attacks
@pytest.mark.parametrize("case", ["end_to_end", "four"])
def test_host_attack_matches_jax(sides, four, case):
    """GreedyAttackMoco.adv_attack_samples against the JAX package's host
    attack (tests/test_attacks.py :201 and :231): the same ids, masks, text
    and change counts; substituted words are candidates of the original."""
    j, t = sides
    if case == "four":
        batch, extras, ref, _ = four
    else:
        batch = _batch(j.cfg, j.tok, SENTENCES[case])
        extras = _extras(j, batch)
        ref = _jax_run(j.host, j, batch, extras)
    ours = _port_run(TG.GreedyAttackMoco(t.cfg, t.model, t.tok, t.syn), batch, extras)
    _same(ours, ref, case)
    assert ours["text"] == ref["text"]
    for orig, new in zip(SENTENCES[case], ours["text"]):
        for ow, nw in zip(orig.split(), new.split()):
            assert ow == nw or nw in t.syn.candidates(ow), (ow, nw)


def test_fused_attack_matches_jax_and_host(sides, four):
    """The port's fused attack against the JAX package's fused attack (both
    without compaction) and, with compaction, against the JAX package's
    and the port's host attacks (tests/test_attacks.py :231); on the CPU it
    launches no kernel and reports its own loop counts."""
    _, t = sides
    batch, extras, ref_host, ref_fused = four
    _same(_port_run(_port_fused(t, greedy_compact_frac=0.0), batch, extras), ref_fused,
          "port fused vs JAX fused, no compaction")
    fused = _port_fused(t)
    FB.reset_launches()
    ours = _port_run(fused, batch, extras)
    assert FB.launches == dict.fromkeys(FB.launches, 0)
    _same(ours, ref_host, "port fused vs JAX host")
    _same(ours, _port_run(TG.GreedyAttackMoco(t.cfg, t.model, t.tok, t.syn), batch, extras),
          "port fused vs port host")
    assert ours["text"] == ref_fused["text"] and ours["num_changes"] > 0
    s = fused.last_stats
    assert 1 <= s["grad_passes"] <= s["loops"] <= t.cfg.max_loops
    assert s["score_forwards"] == s["loops"] and s["host_reads"] == s["loops"] + 1


def test_fused_compaction_exact(sides):
    """greedy_compact_frac 0, 0.25 and 0.5 (tests/test_attacks.py :271): the
    same ids and change counts, equal to the JAX package's host attack; the
    batch's live count decays, so the compact stages run."""
    j, t = sides
    batch = _batch(j.cfg, j.tok, SENTENCES["compaction"])
    extras = _extras(j, batch)
    ref = _jax_run(j.host, j, batch, extras)
    for frac in (0.0, 0.25, 0.5):
        _same(_port_run(_port_fused(t, greedy_compact_frac=frac), batch, extras), ref,
              f"frac {frac}")
    assert ref["num_changes"] > 0


def test_fused_chunked_scoring_exact(sides, four):
    """greedy_score_max_rows = 2 B scores the candidates in chunks of 2 over
    NC = 3 (tests/test_attacks.py :314), on the fused and the host attack:
    the ids of the unchunked attack and of the JAX package."""
    _, t = sides
    batch, extras, ref, _ = four
    B = len(SENTENCES["four"])
    chunked = _port_fused(t, greedy_score_max_rows=2 * B)
    _same(_port_run(chunked, batch, extras), ref, "fused, chunked")
    assert chunked.last_stats["score_forwards"] > chunked.last_stats["loops"]  # chunked
    host = TG.GreedyAttackMoco(t.cfg.replace(greedy_score_max_rows=2 * B), t.model, t.tok,
                               t.syn)
    _same(_port_run(host, batch, extras), ref, "host, chunked")


BUCKET_CASES = {
    # tests/test_attacks.py :580
    "test_attacks": ("files", SENTENCES["four"]),
    # dog -> doggy grows a caption by two sub-tokens, which lifts the
    # bucket's bound from 7 to 9 and the bucket from 8 to 16
    "split": ("split_files", ["dog runs in park", "big red puppy on road",
                              "cat sits in street", "the a on in"]),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_fused_text_bucket_exact(request, case):
    """max_text_len 24: the attack runs at the bucket Ts < 24, a multiple of
    8, and its ids equal those of the attack without the bucket, of the
    port's host attack and of the JAX package's host attack, on the JAX
    package's weights and keys."""
    fixture, sentences = BUCKET_CASES[case]
    j, t = _jax_side(*request.getfixturevalue(fixture), max_text_len=24)
    batch = _batch(j.cfg, j.tok, sentences)
    extras = _extras(j, batch)
    ref = _jax_run(j.host, j, batch, extras)
    for bucket in (False, True):
        att = _port_fused(t, attack_text_bucket=bucket)
        width = att.prep_tables(batch["text_ids"])["gw_tbucket"].shape[1]
        assert width == ((16 if case == "split" else 8) if bucket else 24)
        _same(_port_run(att, batch, extras), ref, f"bucket {bucket} vs JAX host")
    _same(_port_run(TG.GreedyAttackMoco(t.cfg, t.model, t.tok, t.syn), batch, extras), ref,
          "port host vs JAX host")
    assert ref["num_changes"] > 0


# words of several sub-tokens: the fuzz vocabulary adds a continuation piece
# for every letter and a few longer ones, so "unquestionably" is 5 pieces,
# "extraordinarily" 13 (past max_text_len - 2 alone) and candidates such as
# "doggy" (3) and "automobile" (7) change a caption's length when spliced in
SPLIT_WORDS = ["extraordinarily", "unquestionably"]
SPLIT_GROUPS = [g + {"dog": ["doggy"], "car": ["automobile"]}.get(g[0], [])
                for g in SYN_GROUPS] + [["extraordinarily", "remarkably"],
                                        ["unquestionably", "undoubtedly"]]
SPLIT_PIECES = ["un", "##quest", "##ion", "##ab", "##ly"] + [
    "##" + ch for ch in "abcdefghijklmnopqrstuvwxyz"]


@pytest.fixture(scope="module")
def split_files(tmp_path_factory):
    """The fuzz vocabulary and its vectors."""
    d = tmp_path_factory.mktemp("greedy_split")
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    with open(vocab) as f:
        have = set(f.read().split())
    with open(vocab, "a") as f:
        f.write("".join(p + "\n" for p in SPLIT_PIECES if p not in have))
    words = WORDS + [w for g in SPLIT_GROUPS for w in g]
    return vocab, _write_vectors(str(d / "vectors.txt"), SPLIT_GROUPS, words)


def _jax_side(vocab, vectors, **kw):
    """The JAX package's tokenizer, synonyms, model (seed 0), keys and host
    attacker, with the port's Side on the same weights."""
    jtok = JTokenizer(vocab)
    cfg = _cfg(vocab_size=jtok.vocab_size, **kw)
    jmodel = ViLTModel(cfg)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    j = Side(jtok, JG.SynonymTable(vectors, 3, 0.5), cfg, jmodel, params)
    j.state, j.keys = state, _keys_fn(jmodel)
    j.host = JG.GreedyAttackMoco(cfg, jmodel, jtok, j.syn)
    t = Side(WordPieceTokenizer(vocab), TG.SynonymTable(vectors, 3, 0.5), cfg,
             _port_of(cfg, params, state).eval())
    return j, t


@pytest.fixture(scope="module")
def split_side(split_files):
    """(jax, port) at max_text_len 12 with the fuzz vocabulary."""
    return _jax_side(*split_files)


def test_fused_fuzz_parity(split_side):
    """Random sentences with words of several sub-tokens (the M bucket at 8
    and 16, captions truncated at max_text_len, splices that change a
    caption's length, the text bucket's growth bound; tests/test_attacks.py
    :487): in four batches the port's fused and host attacks give the JAX
    package's host attack's ids and change counts, from its keys."""
    j, t = split_side
    assert [len(t.tok.tokenize(w)) for w in SPLIT_WORDS + ["doggy", "automobile"]] \
        == [13, 5, 3, 7]
    host = TG.GreedyAttackMoco(t.cfg, t.model, t.tok, t.syn)
    fused = _port_fused(t)
    pool = WORDS + SPLIT_WORDS
    r = np.random.RandomState(11)
    widths, changed = set(), 0
    for trial in range(4):
        sents = [" ".join(r.choice(pool, size=r.randint(2, 9))) for _ in range(3)]
        batch = _batch(j.cfg, j.tok, sents, seed=trial)
        tables = fused.prep_tables(batch["text_ids"])
        widths.add((tables["gw_tok"].shape[-1], tables["gw_tbucket"].shape[1]))
        extras = _extras(j, batch)
        ref = _jax_run(j.host, j, batch, extras)
        _same(_port_run(fused, batch, extras), ref, f"trial {trial} fused: {sents}")
        _same(_port_run(host, batch, extras), ref, f"trial {trial} host: {sents}")
        changed += sum(ref["changes_verification"])
    assert changed > 0 and {m for m, _ in widths} >= {8, 16}, (changed, widths)


# ------------------------------------------------- extras and the step
def _step_cfg(vocab_size):
    return _cfg(vocab_size=vocab_size, text_view=True, image_view=True, adv_steps_img=1,
                adv_lr_img=0.05, adv_max_norm_img=0.005, momentum=0.99, warmup_steps=0,
                max_steps=100)


@pytest.fixture(scope="module")
def step_case(files, sides):
    """The JAX side of the attacked step on the end_to_end batch: the
    weights (twins apart from the query side), the extras of
    greedy_attack_extras, the attacked ids of the JAX package's host
    attack on those extras (its programs for B = 2 are compiled already),
    the gradient of every parameter with those ids, and the step's result."""
    vocab, vectors = files
    j, _ = sides
    jtok = JTokenizer(vocab)
    cfg = _step_cfg(jtok.vocab_size)
    params, state = ViLTModel(cfg).init(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    batch = _batch(cfg, jtok, SENTENCES["end_to_end"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), cfg, params=params,
                                            state=state)
    extras = jax.jit(lambda p, s, b: JL.greedy_attack_extras(
        cfg, jmodel, "moco", p, s, b))(params, state, jbatch)
    attacked = j.host.adv_attack_samples(params, batch, extras)
    jgrads = _jflat(jax.jit(jax.grad(lambda p: JT.compute_all_tasks(
        cfg, jmodel, p, jts.state, dict(
            jbatch, attacked_text_ids=jnp.asarray(attacked["txt_input_ids"]),
            attacked_text_masks=jnp.asarray(attacked["text_masks"])),
        jax.random.PRNGKey(7), train=True)[0]))(jts.params))
    jfused = JF.FusedGreedyAttack(JG.GreedyAttackMoco(cfg, jmodel, jtok,
                                                      JG.SynonymTable(vectors, 3, 0.5)))
    tables = jfused.prep_tables(batch["text_ids"])
    jstep = JT.make_attacked_train_step(cfg, jmodel, tx, jfused, donate=False)
    jts1, jm = jstep(jts, dict(jbatch, **{k: jnp.asarray(v) for k, v in tables.items()}),
                     jax.random.PRNGKey(7))
    # the one-program step attacked as the host attack did
    assert float(jm["num_changes"]) == attacked["num_changes"] > 0
    return dict(cfg=cfg, params=params, state=state, batch=batch, extras=extras,
                attacked=attacked, jgrads=jgrads, tables=tables, jts1=jts1, jm=jm)


def test_greedy_extras_match_jax_and_leave_the_model(step_case):
    """make_greedy_extras_fn: the post-EMA keys and the queue of the JAX
    package's greedy_attack_extras, twins unchanged afterwards."""
    c = step_case
    cfg = c["cfg"]
    jk, jq, jt = c["extras"]
    ts = TT.create_train_state(cfg, model=_port_of(cfg, c["params"], c["state"]),
                               device="cpu")
    before = leaves_to_jax(ts.model)
    k, q, temp = TL.make_greedy_extras_fn(cfg, ts.model)(
        ts, {key: torch.from_numpy(v) for key, v in c["batch"].items()})
    _close("keys", k, jk)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert temp == jt
    after = leaves_to_jax(ts.model)
    assert all(np.array_equal(after[p], before[p]) for p in before)


def test_attacked_step_matches_jax(files, step_case):
    """make_attacked_train_step (tests/test_attacks.py :435) against the JAX
    package's one-program step on the same weights (twins apart from the
    query side), batch and tables: the loss within rtol 1e-5, every metric
    (num_changes and change_rate among them), the gradient of every
    parameter against the JAX package's with the JAX package's attacked ids,
    and after the step every parameter, twin, the queue and the pointer
    (tests/test_torch_train.py:test_two_moco_steps_match_jax's tolerances);
    the twins moved once.  The step's attack runs the fused attacker's loop
    on the CPU (no kernel launches)."""
    vocab, vectors = files
    c = step_case
    cfg, batch, jm = c["cfg"], c["batch"], c["jm"]
    ts = TT.create_train_state(cfg, model=_port_of(cfg, c["params"], c["state"]),
                               device="cpu")
    fused = TF.FusedGreedyAttack(TG.GreedyAttackMoco(cfg, ts.model, WordPieceTokenizer(vocab),
                                                     TG.SynonymTable(vectors, 3, 0.5)))
    tables = fused.prep_tables(batch["text_ids"])
    for key, v in c["tables"].items():
        np.testing.assert_array_equal(tables[key], v, err_msg=key)
    step = TT.make_attacked_train_step(cfg, ts, fused)
    FB.reset_launches()
    metrics = step(dict({k: torch.from_numpy(v) for k, v in batch.items()}, **tables),
                   torch.Generator().manual_seed(0))
    assert FB.launches == dict.fromkeys(FB.launches, 0)
    assert set(metrics) == set(jm), set(metrics) ^ set(jm)
    np.testing.assert_allclose(metrics["moco_loss"].item(), float(jm["moco_loss"]), rtol=1e-5)
    for key, ref in jm.items():
        np.testing.assert_allclose(metrics[key].item(), float(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    assert metrics["num_changes"].dim() == 0 and metrics["num_changes"].item() > 0
    jgrads = c["jgrads"]
    for path, g in leaves_to_jax(ts.model, grads=True).items():
        _close(f"grad {path}", g, jgrads[path])
    want = {**_jflat(c["jts1"].params), **_jflat(c["jts1"].state)}
    _close_params(leaves_to_jax(ts.model), want,
                  {p: g for p, g in jgrads.items() if not p.startswith("k_")},
                  cfg.learning_rate, "attacked step")
    moved = np.abs(want["k_moco_head/projector/0/kernel"]
                   - np.asarray(c["params"]["k_moco_head"]["projector"]["0"]["kernel"])).max()
    assert moved > 1e-4       # the twins moved, once: within 1e-6 of the JAX package's


def test_build_greedy_attacker_and_refusals(files, sides, four, tmp_path):
    """build_greedy_attacker: the fused moco attacker from the vectors file
    (the host one under greedy_impl="host"), None without the file or
    without a greedy framework; a downstream framework's attacker and
    extras; the attacked step raises for the host attacker and without an
    attacked framework.  The fused attack's decision record holds one entry per
    loop whose commits add up to the change counts."""
    vocab, vectors = files
    _, t = sides
    cfg = t.cfg.replace(embedding_path=vectors, sim_path=str(tmp_path / "sim"))
    att = TL.build_greedy_attacker(cfg, t.model, t.tok)
    assert isinstance(att, TF.FusedGreedyAttack)
    assert att.base.synonyms.table == t.syn.table
    assert isinstance(TL.build_greedy_attacker(cfg.replace(greedy_impl="host"), t.model, t.tok),
                      TG.GreedyAttackMoco)
    assert TL.build_greedy_attacker(cfg.replace(embedding_path=str(tmp_path / "no")),
                                    t.model, t.tok) is None
    assert TL.build_greedy_attacker(cfg.replace(loss_names=loss_names({"vqa": 1})),
                                    t.model, t.tok) is None
    other = cfg.replace(loss_names=loss_names({"nlvr2_attacked": 1}))
    nlvr2 = TL.build_greedy_attacker(other, t.model, t.tok)
    assert isinstance(nlvr2.base, TG.GreedyAttackNlvr2)
    assert callable(TL.make_greedy_extras_fn(other, t.model))
    step_cfg = _step_cfg(t.tok.vocab_size)
    ts = TT.create_train_state(step_cfg, device="cpu")
    with pytest.raises(TypeError, match="fused"):
        TT.make_attacked_train_step(step_cfg, ts, att.base)
    with pytest.raises(ValueError, match="no attacked framework"):
        TT.make_attacked_train_step(step_cfg.replace(loss_names=loss_names({"vqa": 1})), ts,
                                    att)

    batch, extras, ref, _ = four
    att.record = []
    out = _port_run(att, batch, extras)
    _same(out, ref, "built attacker")
    assert len(att.record) == att.last_stats["loops"]
    commits = np.zeros(len(SENTENCES["four"]), int)
    for entry in att.record:
        np.add.at(commits, entry["rows"].numpy(), entry["improved"].numpy().astype(int))
    assert commits.tolist() == out["changes_verification"]
