"""The port's tensor parallelism (rmcl_tpu_torch/parallel/mesh.py, tp.py,
sharding_rules.py; models/vit.py:Block under a model axis) on the CPU.

  * The rules against the JAX package's, without a compile: for every leaf of
    a tiny task_moco + MLM model, ``shard_dim`` names the dimension that
    ``rmcl_tpu/parallel/sharding_rules.py:param_shardings`` shards on a (1, 2)
    CPU mesh; ``gather_state_dict`` inverts ``shard_state_dict`` bit for bit,
    and the qkv shards are aligned to heads.
  * The refusals: a grid that is not the world, a model axis that does not
    divide the heads, the MLP width or the vocabulary, ``zero1`` with a model
    axis.
  * The ops on the shards (plain versions, fp32): the shards' partial sums of
    every half, forward, dx and training backward, add up to the unsharded
    op within 1e-5 x max(1, max|ref|); the sharded gradients are the shards
    of the unsharded ones; the in-MLP keep mask of a shard is the columns of
    the full mask (``keep_mask`` with ``col0``), bit for bit.
  * Blocks of configurations P and F on two shards (two threads of this
    process as the model group: f and g sum across them) against the
    unsharded block, deterministic and in training at p = 0.3: the output,
    the input gradient and every parameter gradient (the shards' the shards
    of the full ones, the LayerNorms' and row-parallel biases' summed over
    the shards) within 1e-5 x max(1, max|ref|).
  * The attacked task_moco step of two ranks on a (1, 2) grid (fp32,
    drop_rate 0, text and image views, the greedy attack, the sizes of
    tests/test_torch_ddp.py) against the JAX package's attacked step on the
    same 4 pairs and weights: the loss within rtol 1e-5, the metrics within
    rtol 1e-4 / atol 1e-5 at step one and 2e-3 at step two, every gathered
    leaf by ``_close_params``, the attacked ids exact; the replicated leaves
    the same bits on both ranks.

The ranks run tests/_torch_ddp_worker.py under torchrun while the JAX step
compiles in this process."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.attacks import greedy as JG
from rmcl_tpu.attacks import greedy_fused as JF
from rmcl_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from rmcl_tpu.data.tokenizer import make_tiny_vocab
from rmcl_tpu.models.vilt import ViLTModel
from rmcl_tpu.parallel.mesh import make_mesh
from rmcl_tpu.parallel.sharding_rules import param_shardings
from rmcl_tpu.train import step as JT
from rmcl_tpu_torch.compat.from_jax import shard_from_jax, state_dict_from_jax
from rmcl_tpu_torch.models.layers import Linear
from rmcl_tpu_torch.models.vilt import ViLT
from rmcl_tpu_torch.models.vit import Block, PatchEmbed, ViT
from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.ops import fused_block_train as FT
from rmcl_tpu_torch.ops.dropout import dropout
from rmcl_tpu_torch.ops.philox import keep_mask
from rmcl_tpu_torch.parallel import mesh
from rmcl_tpu_torch.parallel.sharding_rules import (check_shards, check_zero1, gather_state_dict,
                                                    model_partial, shard_dim, shard_state_dict,
                                                    shard_tensor)
from rmcl_tpu_torch.train.schedule import make_optimizer
from tests._torch_threads import one_thread  # noqa: F401
from tests._torch_ddp_worker import port_cfg, start_ranks
from tests.test_attacks import SYN_GROUPS, WORDS
from tests.test_torch_ddp import close_metrics
from tests.test_torch_greedy import SENTENCES, _batch, _step_cfg, _write_vectors
from tests.test_torch_train import _close, _close_params, _jflat, _perturbed, _port_of
from tests.test_train import _tiny

GRID = ((1, 2), ("data", "model"))


def _mlm_cfg():
    return _tiny({"moco": 1, "mlm": 1}, num_negative=16, momentum=0.99, temperature=0.07,
                 warmup_steps=0)


# ------------------------------------------------------------------ rules
def test_rules_shard_what_param_shardings_shards():
    """Every parameter of a task_moco + MLM model: the torch dimension that
    ``shard_dim`` names is the one ``param_shardings`` puts on the model axis
    (through the kernel's transpose and the stacked blocks' layer axis), and
    None where the JAX package replicates; the model-partial leaves are the
    blocks' LayerNorms and row-parallel biases."""
    cfg = _mlm_cfg()
    shapes = jax.eval_shape(lambda k: ViLTModel(cfg).init(k)[0], jax.random.PRNGKey(0))
    specs = {"/".join(str(k.key) for k in path): s.spec for path, s in
             jax.tree_util.tree_flatten_with_path(param_shardings(
                 shapes, make_mesh(jax.devices()[:2], (1, 2), ("data", "model"))))[0]}
    model = ViLT(port_cfg(cfg))
    kernels = {n + ".weight" for n, m in model.named_modules()
               if isinstance(m, Linear)} | {n + ".proj.weight" for n, m in model.named_modules()
                                            if isinstance(m, PatchEmbed)}
    seen, sharded = set(), 0
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if "blocks" in parts:
            del parts[parts.index("blocks") + 1]
        kernel = name in kernels
        if kernel:
            parts[-1] = "kernel"
        path = "/".join(parts)
        seen.add(path)
        axes = [i for i, a in enumerate(specs[path]) if a == "model"]
        want = None
        if axes:
            a = axes[0] - ("blocks" in parts)
            want = 1 - a if kernel else a
            sharded += 1
        assert shard_dim(name) == want, (name, specs[path])
        assert model_partial(name) == (
            "blocks" in parts and (parts[-2] in ("norm1", "norm2") or
                                   parts[-2:] in (["proj", "bias"], ["fc2", "bias"]))), name
    assert seen == set(specs)
    assert sharded == 2 * 2 * 6 + 2         # 6 a layer, 2 layers, query and twin; the MLM 2


def test_shard_and_gather_are_inverse_and_heads_aligned():
    """``gather_state_dict`` of the m shards is the full state dict bit for bit
    (m = 2 and 4), ``shard_from_jax`` is ``shard_state_dict`` of the JAX
    package's parameters, and a qkv shard holds the q, k and v rows of its
    heads."""
    cfg = _tiny({"moco": 1, "mlm": 1}, num_heads=4, num_negative=16)
    sd = ViLT(port_cfg(cfg)).init(torch.Generator().manual_seed(0)).state_dict()
    for m in (2, 4):
        shards = [shard_state_dict(sd, r, m) for r in range(m)]
        back = gather_state_dict(shards)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), (m, k)
            if shard_dim(k) is not None:
                assert shards[1][k].shape[shard_dim(k)] * m == v.shape[shard_dim(k)], k
    C, D = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
    w = sd["transformer.blocks.0.attn.qkv.weight"]
    part = shard_tensor("transformer.blocks.0.attn.qkv.weight", w, 1, 2)
    for i, (lo, hi) in enumerate([(2 * D, 4 * D)] * 3):       # heads 2, 3 of q, k, v
        assert torch.equal(part[i * 2 * D:(i + 1) * 2 * D], w[i * C + lo:i * C + hi])
    params, state = ViLTModel(cfg).init(jax.random.PRNGKey(0))
    full = state_dict_from_jax(params, cfg.num_layers, state)
    got = shard_from_jax(params, cfg.num_layers, 1, 2, state)
    want = shard_state_dict({k: torch.from_numpy(v) for k, v in full.items()}, 1, 2)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_refusals():
    """A grid that is not the world, a model axis that does not divide the
    heads, the MLP width or the vocabulary, and ``zero1`` with a model axis
    raise."""
    cfg = port_cfg(_mlm_cfg())                 # 2 heads, MLP 128, vocabulary 64
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.init_grid((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="'data' axis"):
        mesh.init_grid((1,), ("model",))
    assert mesh.model_size() == 1
    for m in (3, 4):
        with pytest.raises(ValueError, match="does not divide"):
            check_shards(cfg, m)
        with pytest.raises(ValueError, match="does not divide"):
            ViLT(cfg, model_shards=m)
    with pytest.raises(ValueError, match="vocab_size"):
        check_shards(cfg.replace(vocab_size=63), 2)
    with pytest.raises(ValueError, match="zero1"):
        check_zero1(cfg.replace(zero1=True), 2)
    check_zero1(cfg.replace(zero1=True), 1)
    # an optimizer built on a grid with a model axis
    grid = mesh.Grid(data=1, model=2, data_rank=0, model_rank=0)
    mesh._active = grid
    try:
        with pytest.raises(ValueError, match="zero1"):
            make_optimizer(cfg.replace(zero1=True), torch.nn.Linear(2, 2), 10)
        with pytest.raises(RuntimeError, match="model shards"):
            ViT(32, 4, 1, 4, 16, 32, model_shards=4)(torch.zeros(1, 2, 32),
                                                     torch.ones(1, 2, dtype=torch.int32))
    finally:
        mesh.reset()


# ------------------------------------------------------------ ops on shards
def _block_weights(C, H, r=np.random.RandomState(0)):
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))  # noqa: E731
    return dict(ln_w=1 + 0.1 * t(C), ln_b=0.1 * t(C), wqkv=0.2 * t(3 * C, C),
                bqkv=0.1 * t(3 * C), wproj=0.2 * t(C, C), bproj=0.1 * t(C),
                w1=0.2 * t(4 * C, C), b1=0.1 * t(4 * C), w2=0.1 * t(C, 4 * C), b2=0.1 * t(C))


_NAMES = {"wqkv": "attn.qkv.weight", "bqkv": "attn.qkv.bias", "wproj": "attn.proj.weight",
          "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias", "w2": "mlp.fc2.weight"}


def _shard(w, r, m):
    return {k: shard_tensor("transformer.blocks.0." + _NAMES[k], v, r, m) if k in _NAMES else v
            for k, v in w.items()}


def test_ops_on_shards_add_up_to_the_full_ops():
    """m = 2, fp32, B = 2, S = 7, C = 32, 4 heads, p = 0.3: each half on the
    shards, the residual and the row-parallel bias on shard 0 alone, summed
    over the shards, against the unsharded op: ``attn_half``, ``mlp_half``,
    their dx forms, ``attn_half_full`` and its backward, ``attn_half_train``
    and ``mlp_half_train`` and their backwards (dx summed, LayerNorm and
    row-parallel bias gradients summed, the sharded gradients the shards of the
    full ones); the in-MLP masks the full mask's columns bit for bit, through
    ``mlp_half_train``, ``mlp_half_train_bwd``, ``keep_mask`` and ``dropout``."""
    B, S, C, H, m, p, eps = 2, 7, 32, 4, 2, 0.3, 1e-6
    r = np.random.RandomState(1)
    x = torch.from_numpy(r.randn(B, S, C).astype(np.float32))
    g = torch.from_numpy(r.randn(B, S, C).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, 5:] = 0
    seeds = torch.tensor([12345, -678], dtype=torch.int32)
    w = _block_weights(C, H)
    sh = [_shard(w, k, m) for k in range(m)]

    def summed(fn):
        outs = [fn(s, k == 0) for k, s in enumerate(sh)]
        return outs, (sum(o if isinstance(o, torch.Tensor) else o[0] for o in outs))

    full = FB.attn_half(x, mask, w["ln_w"], w["ln_b"], w["wqkv"], w["bqkv"], w["wproj"],
                        w["bproj"], H, eps)
    _, got = summed(lambda s, lead: FB.attn_half(
        x, mask, s["ln_w"], s["ln_b"], s["wqkv"], s["bqkv"], s["wproj"],
        s["bproj"] if lead else None, H // m, eps, residual=lead))
    _close("attn_half", got, full)
    full = FB.mlp_half(x, w["ln_w"], w["ln_b"], w["w1"], w["b1"], w["w2"], w["b2"], eps)
    _, got = summed(lambda s, lead: FB.mlp_half(
        x, s["ln_w"], s["ln_b"], s["w1"], s["b1"], s["w2"], s["b2"] if lead else None, eps,
        residual=lead))
    _close("mlp_half", got, full)
    full = FB.attn_half_dx(x, mask, w["ln_w"], w["ln_b"], w["wqkv"], w["bqkv"], w["wproj"], g,
                           H, eps)
    _, got = summed(lambda s, lead: FB.attn_half_dx(
        x, mask, s["ln_w"], s["ln_b"], s["wqkv"], s["bqkv"], s["wproj"], g, H // m, eps,
        residual=lead))
    _close("attn_half_dx", got, full)
    full = FB.mlp_half_dx(x, w["ln_w"], w["ln_b"], w["w1"], w["b1"], w["w2"], g, eps)
    _, got = summed(lambda s, lead: FB.mlp_half_dx(
        x, s["ln_w"], s["ln_b"], s["w1"], s["b1"], s["w2"], g, eps, residual=lead))
    _close("mlp_half_dx", got, full)

    # the training halves: forward, then the backward's gradients by kind
    def grads_by_kind(name, full_res, shard_res, keys):
        for i, key in enumerate(keys, start=1):
            parts = [res[i] for res in shard_res]
            if key in ("ln_w", "ln_b", "bproj", "b2"):
                _close(f"{name} d{key}", sum(p for p in parts if p is not None), full_res[i])
                assert all(p is None for p in parts[1:]) or key in ("ln_w", "ln_b"), key
            else:
                want = [shard_tensor("transformer.blocks.0." + _NAMES[key], full_res[i], k, m)
                        for k in range(m)]
                for k in range(m):
                    _close(f"{name} d{key} shard {k}", parts[k], want[k])
        _close(f"{name} dx", sum(res[0] for res in shard_res), full_res[0])

    out, qkv, attn = FB._attn_fwd(x, mask, w["ln_w"], w["ln_b"], w["wqkv"], w["bqkv"],
                                  w["wproj"], w["bproj"], H, eps, False)
    parts, got = summed(lambda s, lead: FB._attn_fwd(
        x, mask, s["ln_w"], s["ln_b"], s["wqkv"], s["bqkv"], s["wproj"],
        s["bproj"] if lead else None, H // m, eps, False))
    _close("attn_half_full", got, out)
    grads_by_kind("attn_half_full", FB.attn_half_full_bwd(
        x, mask, w["ln_w"], w["ln_b"], w["wqkv"], w["wproj"], g, qkv, attn, H, eps),
        [FB.attn_half_full_bwd(x, mask, s["ln_w"], s["ln_b"], s["wqkv"], s["wproj"], g,
                               pr[1], pr[2], H // m, eps, bias=k == 0)
         for k, (s, pr) in enumerate(zip(sh, parts))],
        ("ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj"))

    full = FT._attn_train_fwd(x, seeds, mask, w["ln_w"], w["ln_b"], w["wqkv"], w["bqkv"],
                              w["wproj"], w["bproj"], H, eps, p)
    parts, got = summed(lambda s, lead: FT._attn_train_fwd(
        x, seeds, mask, s["ln_w"], s["ln_b"], s["wqkv"], s["bqkv"], s["wproj"],
        s["bproj"] if lead else None, H // m, eps, p, residual=lead))
    _close("attn_half_train", got, full[0])
    grads_by_kind("attn_half_train", FT.attn_half_train_bwd(
        x, seeds, mask, w["ln_w"], w["ln_b"], w["wqkv"], w["wproj"], g, full[1], full[2], H,
        eps, p),
        [FT.attn_half_train_bwd(x, seeds, mask, s["ln_w"], s["ln_b"], s["wqkv"], s["wproj"], g,
                                pr[1], pr[2], H // m, eps, p, residual=k == 0, bias=k == 0)
         for k, (s, pr) in enumerate(zip(sh, parts))],
        ("ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj"))

    C4 = 4 * C // m
    full = FT._mlp_train_fwd(x, seeds, w["ln_w"], w["ln_b"], w["w1"], w["b1"], w["w2"],
                             w["b2"], eps, p, True)
    parts, got = summed(lambda s, lead: FT._mlp_train_fwd(
        x, seeds, s["ln_w"], s["ln_b"], s["w1"], s["b1"], s["w2"], s["b2"] if lead else None,
        eps, p, True, residual=lead, col0=(0 if lead else C4)))
    _close("mlp_half_train", got, full[0])
    for k, pr in enumerate(parts):
        cols = slice(k * C4, (k + 1) * C4)
        assert torch.equal(pr[3], full[3][..., cols])
        assert torch.equal(pr[3], keep_mask(seeds, 0, S, C4, p, k * C4))
        assert torch.equal(dropout(full[1][..., cols].contiguous(), seeds, 0, p, k * C4),
                           dropout(full[1], seeds, 0, p)[..., cols])
        res = FT.mlp_half_train_bwd(x, seeds, sh[k]["ln_w"], sh[k]["ln_b"], sh[k]["w1"],
                                    sh[k]["w2"], g, pr[1], pr[2], p, eps, emit_mask=True,
                                    col0=k * C4)
        assert torch.equal(res[7], full[3][..., cols])
    grads_by_kind("mlp_half_train", FT.mlp_half_train_bwd(
        x, seeds, w["ln_w"], w["ln_b"], w["w1"], w["w2"], g, full[1], full[2], p, eps),
        [FT.mlp_half_train_bwd(x, seeds, s["ln_w"], s["ln_b"], s["w1"], s["w2"], g, pr[1],
                               pr[2], p, eps, residual=k == 0, bias=k == 0, col0=k * C4)
         for k, (s, pr) in enumerate(zip(sh, parts))],
        ("ln_w", "ln_b", "w1", "b1", "w2", "b2"))


class _TwoShards:
    """The model group of two shards as two threads of this process: a
    thread's ``mesh.model_rank()`` is its shard, and the model group's sum
    (g forward, f backward) adds the two threads' tensors, shard 0's first."""

    def __init__(self):
        self.local, self.slots = threading.local(), [None, None]
        self.barrier = threading.Barrier(2, timeout=60)

    def rank(self) -> int:
        return self.local.rank

    def all_reduce(self, x):
        self.slots[self.local.rank] = x
        self.barrier.wait()
        out = self.slots[0] + self.slots[1]
        self.barrier.wait()
        return out

    def run(self, fn):
        """fn(shard) on both shards at once; their results."""
        out, errors = [None, None], []

        def body(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:     # noqa: BLE001  re-raised below
                errors.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=body, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a shard did not finish"
        if errors:
            raise errors[0]
        return out


@pytest.mark.parametrize("impls", [("pallas", "fused_train"), ("fused", "fused")],
                         ids=["P", "F"])
def test_p_and_f_blocks_on_two_shards_add_up_to_the_full_block(impls, monkeypatch):
    """Configurations P and F: a block of C = 32, 4 heads on two shards
    against the unsharded block, fp32, B = 2, S = 7 with a key masked:
    deterministic, then the training forward at p = 0.3 and its backward
    from a random output gradient; every output and gradient within 1e-5 x
    max(1, max|ref|)."""
    from rmcl_tpu_torch.parallel import tp
    B, S, C, H, m, p = 2, 7, 32, 4, 2, 0.3
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randn(B, S, C).astype(np.float32))
    gout = torch.from_numpy(r.randn(B, S, C).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, 5:] = 0
    seeds = torch.tensor([[12345, -678], [91, -2 ** 31]], dtype=torch.int32)
    full = Block(C, H, 4, *impls)
    w = _block_weights(C, H)
    names = {"ln_w": "norm1.weight", "ln_b": "norm1.bias", "wqkv": "attn.qkv.weight",
             "bqkv": "attn.qkv.bias", "wproj": "attn.proj.weight", "bproj": "attn.proj.bias",
             "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias", "w2": "mlp.fc2.weight",
             "b2": "mlp.fc2.bias"}
    sd = {names[k]: v for k, v in w.items()}
    sd.update({"norm2.weight": w["ln_w"] * 0.9, "norm2.bias": -w["ln_b"]})
    full.load_state_dict(sd)
    shards = []
    for k in range(m):
        blk = Block(C, H, 4, *impls, model_shards=m)
        blk.load_state_dict({n: shard_tensor("transformer.blocks.0." + n, v, k, m)
                             for n, v in sd.items()})
        shards.append(blk)
    group = _TwoShards()
    monkeypatch.setattr(mesh, "_active", mesh.Grid(data=1, model=m, data_rank=0, model_rank=0))
    monkeypatch.setattr(mesh, "model_rank", group.rank)
    monkeypatch.setattr(tp, "_all_reduce", group.all_reduce)

    def infer(blk):
        with torch.no_grad():                  # grad mode is a thread's own
            return blk(x, mask, blk.matrices(x.dtype))
    want = infer(full)
    got = group.run(lambda k: infer(shards[k]))
    for k in range(m):
        _close(f"{impls} deterministic, shard {k}", got[k], want)

    def train(blk):
        xi = x.clone().requires_grad_(True)
        out = blk(xi, mask, blk.matrices(x.dtype), seeds, p)
        (out * gout).sum().backward()
        return out.detach(), xi.grad, {n: q.grad for n, q in blk.named_parameters()}
    want = train(full)
    got = group.run(lambda k: train(shards[k]))
    for k in range(m):
        _close(f"{impls} training, shard {k}", got[k][0], want[0])
        _close(f"{impls} dx, shard {k}", got[k][1], want[1])
    for n, ref in want[2].items():
        parts = [got[k][2][n] for k in range(m)]
        if shard_dim("transformer.blocks.0." + n) is None:
            _close(f"{impls} d{n}", sum(q for q in parts if q is not None), ref)
        else:
            for k in range(m):
                _close(f"{impls} d{n} shard {k}", parts[k],
                       shard_tensor("transformer.blocks.0." + n, ref, k, m))


# ------------------------------------------------------- the attacked step
@pytest.fixture(scope="module")
def moco(tmp_path_factory):
    """tests/test_torch_ddp.py's attacked-step case (4 pairs, twins apart from
    the query side, drop_rate 0): two steps of the JAX package's attacked step
    in this process while two ranks of a (1, 2) grid run the port's."""
    d = tmp_path_factory.mktemp("tp")
    vocab = make_tiny_vocab(str(d / "vocab.txt"), WORDS)
    vectors = _write_vectors(str(d / "vectors.txt"), SYN_GROUPS, WORDS)
    jtok = JTokenizer(vocab)
    jcfg = _step_cfg(jtok.vocab_size)
    params, state = ViLTModel(jcfg).init(jax.random.PRNGKey(0))
    params = {k: _perturbed(v, 3) if k.startswith("k_") else v for k, v in params.items()}
    batch = _batch(jcfg, jtok, SENTENCES["four"])
    run = dict(cfg=port_cfg(jcfg), state_dict=_port_of(jcfg, params, state).state_dict(),
               batches=[batch, batch], attack=(vocab, vectors), seed=0)
    ranks = start_ranks({"case": "steps", "runs": [run], "grid": GRID}, d)

    jmodel, jts, tx = JT.create_train_state(jax.random.PRNGKey(0), jcfg, params=params,
                                            state=state)
    jfused = JF.FusedGreedyAttack(JG.GreedyAttackMoco(jcfg, jmodel, jtok,
                                                      JG.SynonymTable(vectors, 3, 0.5)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tables = {k: jnp.asarray(v) for k, v in jfused.prep_tables(batch["text_ids"]).items()}
    jstep = JT.make_attacked_train_step(jcfg, jmodel, tx, jfused, donate=False)
    jsteps = []
    for it in range(2):
        jts, jm = jstep(jts, dict(jbatch, **tables), jax.random.PRNGKey(7 + it))
        jsteps.append(({k: float(v) for k, v in jm.items()},
                       {**_jflat(jts.params), **_jflat(jts.state)}))
    return dict(cfg=jcfg, jsteps=jsteps, ranks=[r[0] for r in ranks.result()])


def test_attacked_moco_step_on_a_model_axis_matches_jax(moco):
    """Two ranks of a (1, 2) grid against the JAX package's attacked step on
    the 4 pairs: the metrics (the loss within rtol 1e-5, num_changes > 0),
    every gathered leaf after each step, the two ranks' attacked ids equal
    (each computes the whole batch's), the replicated leaves and their AdamW
    moments the same bits on both ranks at every step, the sharded ones
    not."""
    r0, r1 = moco["ranks"]
    assert r0["grid"] == (0, 0) and r1["grid"] == (0, 1)
    assert r0["replicated"] == r1["replicated"] and r0["hash"][0] != r1["hash"][0]
    assert r0["metrics"] == r1["metrics"]
    for a, b in zip(r0["ids"], r1["ids"]):
        np.testing.assert_array_equal(a, b)
    jm0 = moco["jsteps"][0][0]
    assert r0["metrics"][0]["num_changes"] == jm0["num_changes"] > 0
    np.testing.assert_allclose(r0["metrics"][0]["moco_loss"], jm0["moco_loss"], rtol=1e-5)
    for it, (jm, want) in enumerate(moco["jsteps"]):
        close_metrics(r0["metrics"][it], jm, 1e-4 if it == 0 else 2e-3, f"step {it}")
        for r in (r0, r1):
            assert set(r["leaves"][it]) == set(want)
            firm = {p: g for p, g in r["grads"][0].items() if not p.startswith("k_")}
            _close_params(r["leaves"][it], want, firm, moco["cfg"].learning_rate, f"step {it}")
    assert int(r0["leaves"][1]["proj_queue_ptr"]) == 8
