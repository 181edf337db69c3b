"""The CUDA block kernels (rmcl_tpu_torch/csrc/block_kernels.cu), forward
and dx-only backward, and the training forward and full backward, against
their plain versions; one PGD step, one training step and the fused greedy
text attack, on the card.  Every case is marked ``cuda`` and skips
where there is no CUDA device.  This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from rmcl_tpu_torch.ops import fused_block as FB
from rmcl_tpu_torch.ops import fused_block_train as FT
from rmcl_tpu_torch.ops.philox import keep_mask

EPS = 1e-6
# (B, S, C, H, key mask): ragged S everywhere; "tail" pads the last keys,
# "first_tile" masks every key of the first 64-key tile (a valid key comes
# later), D = 8, 64 and 128
SHAPES = [(2, 37, 32, 4, "tail"), (3, 150, 256, 4, "first_tile"),
          (2, 70, 256, 2, "random")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, S, C, H, kind, dev, dtype, seed=0):
    r = np.random.RandomState(seed)
    mask = (r.rand(B, S) > 0.3).astype(np.int32)
    if kind == "tail":
        mask[:, 0], mask[:, -7:] = 1, 0
    elif kind == "first_tile":
        mask[:, :64], mask[:, 100] = 0, 1
    else:
        mask[:, 0] = 1
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev, dt)
    w = lambda *s: t(0.1 * r.randn(*s), dtype)  # noqa: E731
    x = t(r.randn(B, S, C), dtype)
    ln = (t(1.0 + 0.1 * r.randn(C)), t(0.1 * r.randn(C)))
    attn = (x, torch.from_numpy(mask).to(dev), *ln, w(3 * C, C),
            t(0.1 * r.randn(3 * C)), w(C, C), t(0.1 * r.randn(C)), H, EPS)
    mlp = (x, *ln, w(4 * C, C), t(0.1 * r.randn(4 * C)), w(C, 4 * C),
           t(0.1 * r.randn(C)), EPS)
    return attn, mlp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_kernels_match_plain(cuda, shape, dtype, tol, residual):
    """Error relative to max(1, max|ref|): fp32 differs in summation order
    only; bf16 also in where P and the online softmax's terms round."""
    attn, mlp = _inputs(*shape, cuda, dtype)
    with torch.inference_mode():
        for op, plain, args in ((FB.attn_half, FB.attn_half_plain, attn),
                                (FB.mlp_half, FB.mlp_half_plain, mlp)):
            ref = plain(*args, residual=residual).float()
            before = FB.launches[op.__name__]
            out = op(*args, residual=residual).float()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            assert err <= tol * max(1.0, ref.abs().max().item()), (op.__name__, err)
            assert FB.launches[op.__name__] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("saved", [True, False], ids=["saved", "recompute"])
def test_dx_kernels_match_plain(cuda, shape, dtype, tol, residual, saved):
    """The dx ops against their plain versions on the same inputs (the saved
    variants on the same saved qkv / h, taken from the forward kernels).
    Error relative to max(1, max|ref|), as for the forwards."""
    attn, mlp = _inputs(*shape, cuda, dtype)
    g = torch.from_numpy(np.random.RandomState(7).randn(*attn[0].shape)
                         .astype(np.float32)).to(cuda, dtype)
    with torch.inference_mode():
        qkv = FB._attn_fwd(*attn, residual)[1] if saved else None
        h = FB._mlp_fwd(*mlp, residual, keep_h=True)[1] if saved else None
        x, mask, lw, lb, wqkv, bqkv, wproj, _, H, eps = attn
        a_args = (x, mask, lw, lb, wqkv, bqkv, wproj, g, H, eps, residual, qkv)
        x, lw, lb, w1, b1, w2, _, eps = mlp
        m_args = (x, lw, lb, w1, b1, w2, g, eps, residual, h)
        for op, plain, args in ((FB.attn_half_dx, FB.attn_half_dx_plain, a_args),
                                (FB.mlp_half_dx, FB.mlp_half_dx_plain, m_args)):
            ref = plain(*args).float()
            before = FB.launches[op.__name__]
            out = op(*args).float()
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all()), op.__name__
            err = (out - ref).abs().max().item()
            assert err <= tol * max(1.0, ref.abs().max().item()), (op.__name__, err)
            assert FB.launches[op.__name__] == before + 1


@pytest.mark.cuda
def test_dx_fully_masked_sample(cuda):
    """Every key of one sample masked: P is uniform in the backward as in the
    forward (the -1e30 bias is finite), and dx stays finite and right."""
    attn, _ = _inputs(2, 70, 256, 2, "random", cuda, torch.float32)
    attn[1][1] = 0
    x, mask, lw, lb, wqkv, bqkv, wproj, _, H, eps = attn
    g = torch.ones_like(x) * 0.5
    with torch.inference_mode():
        ref = FB.attn_half_dx_plain(x, mask, lw, lb, wqkv, bqkv, wproj, g, H, eps)
        out = FB.attn_half_dx(x, mask, lw, lb, wqkv, bqkv, wproj, g, H, eps)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("save", [True, False], ids=["saved", "recompute"])
def test_autograd_runs_the_dx_kernels(cuda, save):
    """autograd.grad through both halves on the card goes through the dx
    kernels (launch counters) and agrees with autograd through the plain
    versions."""
    attn, mlp = _inputs(*SHAPES[2], cuda, torch.float32)
    g = torch.from_numpy(np.random.RandomState(8).randn(*attn[0].shape)
                         .astype(np.float32)).to(cuda)

    def run(attn_op, mlp_op, **kw):
        x = attn[0].clone().requires_grad_(True)
        y = mlp_op(attn_op(x, *attn[1:], **kw), *mlp[1:], **kw)
        return torch.autograd.grad(y, x, g)[0]

    FB.reset_launches()
    ours = run(FB.attn_half, FB.mlp_half, save_for_backward=save)
    assert FB.launches == {**dict.fromkeys(FB.launches, 0), "attn_half": 1, "mlp_half": 1,
                           "attn_half_dx": 1, "mlp_half_dx": 1}
    ref = run(FB.attn_half_plain, FB.mlp_half_plain)
    torch.cuda.synchronize()
    assert (ours - ref).abs().max().item() <= 2e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_kernels_refuse_grad_and_bad_layouts(cuda):
    attn, _ = _inputs(*SHAPES[0], cuda, torch.float32)
    args = list(attn)
    args[4] = args[4].clone().requires_grad_(True)   # a weight that wants a gradient
    with pytest.raises(RuntimeError, match="x only"):
        FB.attn_half(*args)
    args[4] = attn[4].t()            # a (C, 3C) view: not the kernel's layout
    with torch.inference_mode(), pytest.raises(ValueError):
        FB.attn_half(*args)
    args[4] = attn[4].to(torch.bfloat16)
    with torch.inference_mode(), pytest.raises(TypeError):
        FB.attn_half(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
def test_pgd_step_on_card_matches_cpu(cuda, fast):
    """One make_pgd_moco step of a small seeded model: the card (kernels,
    fp32) against the CPU (plain ops), and every block forward and backward
    on the card went through the kernels."""
    from rmcl_tpu_torch.attacks.pgd import make_pgd_moco
    from rmcl_tpu_torch.core.config import build_config, loss_names
    from rmcl_tpu_torch.objectives.losses import l2_normalize
    from rmcl_tpu_torch.serve import seeded_model

    cfg = build_config(hidden_size=64, num_heads=2, num_layers=3, patch_size=16,
                       image_size=32, image_bucket_hw=(32, 48), max_text_len=12,
                       vocab_size=64, loss_names=loss_names({"moco": 1}), num_negative=32,
                       temperature=0.07, compute_dtype="float32", max_image_len=4)
    cpu = seeded_model(cfg, 0).eval()
    r = np.random.RandomState(0)
    img = np.zeros((3, 6, 768), np.float32)
    img[:, :5] = r.uniform(-1, 1, (3, 5, 768))
    img[1, 3:] = 0
    batch = {"image": torch.from_numpy(img),
             "text_ids": torch.from_numpy(r.randint(5, 64, (3, 12)).astype(np.int32)),
             "text_masks": torch.ones(3, 12, dtype=torch.int32)}
    with torch.no_grad():
        k = l2_normalize(cpu.k_moco_head(cpu.infer_k(batch)["cls_feats"]), 1)
    ref = make_pgd_moco(cpu, 1, 0.05, 0.005, 0.07, fast=fast)(batch, k, cpu.proj_queue)

    import copy
    gpu = copy.deepcopy(cpu).to(cuda)
    FB.reset_launches()
    ours = make_pgd_moco(gpu, 1, 0.05, 0.005, 0.07, fast=fast)(
        {n: v.to(cuda) for n, v in batch.items()}, k.to(cuda), gpu.proj_queue)
    torch.cuda.synchronize()
    assert FB.launches == {**dict.fromkeys(FB.launches, 0), "attn_half": 3, "mlp_half": 3,
                           "attn_half_dx": 3, "mlp_half_dx": 3}
    assert ref.abs().max().item() > 0
    assert (ours.cpu() - ref).abs().max().item() <= 1e-5


# ------------------------------------------------------------ training ops
def _seeds(B, dev):
    return torch.from_numpy(np.random.RandomState(11).randint(
        -2 ** 31, 2 ** 31, B).astype(np.int32)).to(dev)


def _close(name, out, ref, tol):
    """Error relative to max(1, max|ref|) of that output alone."""
    out, ref = out.float(), ref.float()
    assert bool(torch.isfinite(out).all()), name
    err = (out - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), (name, err)


GRAD_NAMES = ("dx", "dln_w", "dln_b", "dw_a", "db_a", "dw_b", "db_b")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
def test_train_attn_kernels_match_plain(cuda, shape, dtype, tol, p):
    """attn_half_train and attn_half_train_bwd against their plain versions on
    the same inputs and the same saved qkv / attn; the masks the kernels emit,
    forward and backward, are philox.keep_mask bit for bit; two backward calls
    give identical bits (no atomics)."""
    attn, _ = _inputs(*shape, cuda, dtype)
    x, mask, lw, lb, wqkv, bqkv, wproj, bproj, H, eps = attn
    B, S, C = x.shape
    seeds = _seeds(B, cuda)
    g = torch.from_numpy(np.random.RandomState(7).randn(B, S, C).astype(np.float32)).to(
        cuda, dtype)
    want = keep_mask(seeds, 0, S, C, p)
    with torch.no_grad():
        before = dict(FB.launches)
        out, m_f = FT.attn_half_train(x, seeds, mask, lw, lb, wqkv, bqkv, wproj, bproj,
                                      H, eps, p, emit_mask=True)
        assert torch.equal(m_f, want)
        _close("fwd", out, FT.attn_half_train_plain(x, seeds, mask, lw, lb, wqkv, bqkv,
                                                    wproj, bproj, H, eps, p), tol)
        _, qkv, att, _ = FT._attn_train_fwd(x, seeds, mask, lw, lb, wqkv, bqkv, wproj,
                                            bproj, H, eps, p)
        args = (x, seeds, mask, lw, lb, wqkv, wproj, g, qkv, att, H, eps, p)
        *ours, m_b = FT.attn_half_train_bwd(*args, emit_mask=True)
        assert torch.equal(m_b, want)
        again = FT.attn_half_train_bwd(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(GRAD_NAMES, ours, again):
            assert torch.equal(a, b), name
        for name, a, b in zip(GRAD_NAMES, ours, FT.attn_half_train_bwd_plain(*args)):
            assert a.dtype == (dtype if name == "dx" else torch.float32)
            _close(name, a, b, tol)
        assert FB.launches["attn_half_train"] == before["attn_half_train"] + 2
        assert FB.launches["attn_half_train_bwd"] == before["attn_half_train_bwd"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("tail", [True, False], ids=["tail", "notail"])
def test_train_mlp_kernels_match_plain(cuda, shape, dtype, tol, p, tail):
    """mlp_half_train and mlp_half_train_bwd, as for the attention half; both
    masks of both directions against philox.keep_mask."""
    _, mlp = _inputs(*shape, cuda, dtype)
    x, lw, lb, w1, b1, w2, b2, eps = mlp
    B, S, C = x.shape
    seeds = _seeds(B, cuda)
    g = torch.from_numpy(np.random.RandomState(7).randn(B, S, C).astype(np.float32)).to(
        cuda, dtype)
    want = keep_mask(seeds, 0, S, 4 * C, p)
    want2 = keep_mask(seeds, 1, S, C, p) if tail else None

    def same_masks(m, m2):
        assert torch.equal(m, want)
        assert m2 is None if want2 is None else torch.equal(m2, want2)

    with torch.no_grad():
        out, m, m2 = FT.mlp_half_train(x, seeds, lw, lb, w1, b1, w2, b2, p, eps, tail,
                                       emit_mask=True)
        same_masks(m, m2)
        _close("fwd", out, FT.mlp_half_train_plain(x, seeds, lw, lb, w1, b1, w2, b2, p, eps,
                                                   tail), tol)
        _, h, a_d, _, _ = FT._mlp_train_fwd(x, seeds, lw, lb, w1, b1, w2, b2, eps, p, tail)
        args = (x, seeds, lw, lb, w1, w2, g, h, a_d, p, eps, tail)
        *ours, m, m2 = FT.mlp_half_train_bwd(*args, emit_mask=True)
        same_masks(m, m2)
        again = FT.mlp_half_train_bwd(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(GRAD_NAMES, ours, again):
            assert torch.equal(a, b), name
        for name, a, b in zip(GRAD_NAMES, ours, FT.mlp_half_train_bwd_plain(*args)):
            _close(name, a, b, tol)


@pytest.mark.cuda
def test_train_bwd_fully_masked_sample(cuda):
    """Every key of one sample masked: the sample's rows give the same dx and
    the same share of every weight gradient as in the plain version."""
    attn, _ = _inputs(2, 70, 256, 2, "random", cuda, torch.float32)
    attn[1][1] = 0
    x, mask, lw, lb, wqkv, bqkv, wproj, bproj, H, eps = attn
    seeds = _seeds(2, cuda)
    g = torch.ones_like(x) * 0.5
    with torch.no_grad():
        _, qkv, att, _ = FT._attn_train_fwd(x, seeds, mask, lw, lb, wqkv, bqkv, wproj,
                                            bproj, H, eps, 0.1)
        args = (x, seeds, mask, lw, lb, wqkv, wproj, g, qkv, att, H, eps, 0.1)
        for name, a, b in zip(GRAD_NAMES, FT.attn_half_train_bwd(*args),
                              FT.attn_half_train_bwd_plain(*args)):
            _close(name, a, b, 2e-4)


@pytest.mark.cuda
def test_autograd_runs_the_training_kernels(cuda):
    """loss.backward() through both training halves on the card: fp32 master
    parameters receive fp32 gradients from the backward kernels (launch
    counters), equal to autograd through differentiable torch ops fed the
    same masks, with bf16 operands cast by the caller."""
    attn, mlp = _inputs(*SHAPES[2], cuda, torch.float32)
    x0, mask, *pa, H, eps = attn
    pm = list(mlp[1:7])
    params = [t.clone().requires_grad_(True) for t in (*pa, *pm)]
    seeds, p = _seeds(x0.shape[0], cuda), 0.1
    x = x0.clone().requires_grad_(True)
    FB.reset_launches()
    y = FT.attn_half_train(x, seeds, mask, *params[:6], H, eps, p)
    y = FT.mlp_half_train(y, seeds, *params[6:], p, eps)
    ours = torch.autograd.grad(y.square().sum(), [x, *params])
    assert FB.launches == {**dict.fromkeys(FB.launches, 0), "attn_half_train": 1,
                           "mlp_half_train": 1, "attn_half_train_bwd": 1,
                           "mlp_half_train_bwd": 1}

    import torch.nn.functional as F
    B, S, C = x.shape
    lw, lb, wq, bq, wp, bp, lw2, lb2, w1, b1, w2, b2 = params
    inv = 1.0 / (1.0 - p)
    qkv = F.linear(F.layer_norm(x, (C,), lw, lb, eps), wq, bq)
    q, k, v = qkv.reshape(B, S, 3, H, C // H).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v, attn_mask=(mask > 0)[:, None, None, :])
    o = F.linear(a.transpose(1, 2).reshape(B, S, C), wp, bp)
    x1 = x + o * keep_mask(seeds, 0, S, C, p) * inv
    hid = F.gelu(F.linear(F.layer_norm(x1, (C,), lw2, lb2, eps), w1, b1))
    hid = hid * keep_mask(seeds, 0, S, 4 * C, p) * inv
    ref_y = x1 + F.linear(hid, w2, b2) * keep_mask(seeds, 1, S, C, p) * inv
    ref = torch.autograd.grad(ref_y.square().sum(), [x, *params])
    torch.cuda.synchronize()
    for i, (a_, b_) in enumerate(zip(ours, ref)):
        assert a_.dtype == torch.float32
        _close(f"grad {i}", a_, b_, 2e-4)


# ------------------------------------- the other block configurations' ops
def _heads(B, S, C, H, kind, dev, dtype, packed, seed=3):
    """q, k, v (B, H, S, D) on the card: contiguous, or views of one packed
    (B, S, 3C) buffer as the unfused block hands them over; and the mask."""
    attn, _ = _inputs(B, S, C, H, kind, dev, dtype, seed)
    r = np.random.RandomState(seed + 1)
    qkv = torch.from_numpy(r.randn(B, S, 3 * C).astype(np.float32)).to(dev, dtype)
    q, k, v = qkv.view(B, S, 3, H, C // H).permute(2, 0, 3, 1, 4).unbind(0)
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v, attn[1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("packed", [True, False], ids=["views", "contiguous"])
def test_masked_attention_kernels_match_plain(cuda, shape, dtype, tol, packed):
    """The attention-core op (pallas_attention.py rows 10, 11) against its
    plain versions on the same inputs: the forward against ``mha``, the
    backward against ``masked_attention_bwd_plain`` (row 11's rounding
    points); the backward bit-identical twice; one launch of each."""
    from rmcl_tpu_torch.ops import attention as A
    q, k, v, mask = _heads(*shape, cuda, dtype, packed)
    scale = q.shape[-1] ** -0.5
    g = torch.from_numpy(np.random.RandomState(9).randn(*q.shape).astype(np.float32)).to(
        cuda, dtype)
    with torch.no_grad():
        before = dict(FB.launches)
        out = A.masked_attention(q, k, v, mask, scale)
        assert out.shape == q.shape
        _close("out", out, A.mha(q, k, v, mask, scale), tol)
        grads = A.masked_attention_bwd(q, k, v, mask, g, scale)
        again = A.masked_attention_bwd(q, k, v, mask, g, scale)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("dq", "dk", "dv"), grads, again,
                                 A.masked_attention_bwd_plain(q, k, v, mask, g, scale)):
            assert torch.equal(a, b), name
            assert a.dtype == dtype and a.shape == q.shape
            _close(name, a, c, tol)
        assert FB.launches["masked_attention"] == before["masked_attention"] + 1
        assert FB.launches["masked_attention_bwd"] == before["masked_attention_bwd"] + 2


@pytest.mark.cuda
def test_masked_attention_autograd_runs_the_kernels(cuda):
    """autograd through the op on views of a qkv projection: the kernels in
    both directions, the gradient of the projection as autograd through the
    plain version gives it."""
    from rmcl_tpu_torch.ops import attention as A
    B, S, C, H = 2, 70, 256, 4
    r = np.random.RandomState(5)
    qkv0 = torch.from_numpy(r.randn(B, S, 3 * C).astype(np.float32)).to(cuda)
    mask = torch.from_numpy((r.rand(B, S) > 0.3).astype(np.int32)).to(cuda)
    mask[:, 0] = 1
    g = torch.from_numpy(r.randn(B, H, S, C // H).astype(np.float32)).to(cuda)

    def grad_of(fn):
        qkv = qkv0.clone().requires_grad_(True)
        q, k, v = qkv.view(B, S, 3, H, C // H).permute(2, 0, 3, 1, 4).unbind(0)
        return torch.autograd.grad(fn(q, k, v, mask, (C // H) ** -0.5), qkv, g)[0]

    FB.reset_launches()
    ours = grad_of(A.masked_attention)
    assert FB.launches == {**dict.fromkeys(FB.launches, 0), "masked_attention": 1,
                           "masked_attention_bwd": 1}
    _close("dqkv", ours, grad_of(A.mha), 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
def test_attn_half_full_kernels_match_plain(cuda, shape, dtype, tol):
    """attn_half_full (row 1's chain, no residual) and attn_half_full_bwd
    (pallas_block.py row 2) against their plain versions on the same kept
    qkv / attn; the seven backward outputs bit-identical twice."""
    attn, _ = _inputs(*shape, cuda, dtype)
    x, mask, lw, lb, wqkv, bqkv, wproj, bproj, H, eps = attn
    g = torch.from_numpy(np.random.RandomState(7).randn(*x.shape).astype(np.float32)).to(
        cuda, dtype)
    with torch.no_grad():
        before = dict(FB.launches)
        out = FB.attn_half_full(x, mask, lw, lb, wqkv, bqkv, wproj, bproj, H, eps)
        _close("fwd", out, FB.attn_half_plain(*attn, residual=False), tol)
        _, qkv, att = FB._attn_fwd(*attn, False)
        args = (x, mask, lw, lb, wqkv, wproj, g, qkv, att, H, eps)
        ours, again = FB.attn_half_full_bwd(*args), FB.attn_half_full_bwd(*args)
        torch.cuda.synchronize()
        for name, a, b, c in zip(GRAD_NAMES, ours, again, FB.attn_half_full_bwd_plain(*args)):
            assert torch.equal(a, b), name
            assert a.dtype == (dtype if name == "dx" else torch.float32)
            _close(name, a, c, tol)
        assert FB.launches["attn_half_full"] == before["attn_half_full"] + 1
        assert FB.launches["attn_half_full_bwd"] == before["attn_half_full_bwd"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dropout_op_matches_plain_bit_for_bit(cuda, dtype):
    """ops/dropout.py: the drop_scale kernel in both directions gives the bits
    of philox.keep_mask + layers.dropout."""
    from rmcl_tpu_torch.models.layers import dropout as dropout_plain
    from rmcl_tpu_torch.ops.dropout import dropout
    B, S, N, p = 3, 37, 96, 0.1
    seeds = _seeds(B, cuda)
    x0 = torch.from_numpy(np.random.RandomState(2).randn(B, S, N).astype(np.float32)).to(
        cuda, dtype)
    g = torch.from_numpy(np.random.RandomState(3).randn(B, S, N).astype(np.float32)).to(
        cuda, dtype)
    keep = keep_mask(seeds, 1, S, N, p)
    x = x0.clone().requires_grad_(True)
    FB.reset_launches()
    out = dropout(x, seeds, 1, p)
    dx, = torch.autograd.grad(out, x, g)
    assert FB.launches["dropout"] == 2
    assert torch.equal(out, dropout_plain(x0, keep, p))
    assert torch.equal(dx, dropout_plain(g, keep, p))
    assert dropout(x0, seeds, 1, 0.0) is x0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
def test_halves_at_tensor_parallel_shard_shapes(cuda, dtype, tol):
    """attn_half and mlp_half at a two-way shard's shapes
    (scripts/bench_tp_kernel_shapes.py): half the heads, qkv C -> 3 C/2, proj
    C/2 -> C without the residual, fc1 C -> 2C, fc2 2C -> C."""
    attn, mlp = _inputs(2, 70, 256, 4, "random", cuda, dtype)
    x, mask, lw, lb, wqkv, bqkv, wproj, bproj, H, eps = attn
    Ci = 128
    qs = torch.cat([wqkv[i * 256:i * 256 + Ci] for i in range(3)])
    qb = torch.cat([bqkv[i * 256:i * 256 + Ci] for i in range(3)])
    a_args = (x, mask, lw, lb, qs, qb, wproj[:, :Ci].contiguous(), bproj, H // 2, eps)
    x, lw, lb, w1, b1, w2, b2, eps = mlp
    m_args = (x, lw, lb, w1[:512].contiguous(), b1[:512], w2[:, :512].contiguous(), b2, eps)
    with torch.inference_mode():
        for op, plain, args in ((FB.attn_half, FB.attn_half_plain, a_args),
                                (FB.mlp_half, FB.mlp_half_plain, m_args)):
            out = op(*args, residual=False)
            assert out.shape == x.shape
            _close(op.__name__, out, plain(*args, residual=False), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("impls", [("fused", "fused"), ("pallas", "fused_train")],
                         ids=["F", "P"])
def test_block_configurations_on_card_match_cpu(cuda, impls):
    """A 2-layer ViT's training forward and backward at p = 0.1 under config F
    (fused attention with row 2's backward, plain MLP) and config P (the
    unfused block around rows 10 and 11): the card's kernels against the
    CPU's plain ops from the same weights, input and seeds; every block op
    of the configuration launched its kernel."""
    import copy
    from rmcl_tpu_torch.models.vit import ViT
    gen = torch.Generator().manual_seed(0)
    cpu = ViT(64, 2, 2, 4, 16, 32, *impls)
    for prm in cpu.parameters():
        with torch.no_grad():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1 + (prm.dim() == 1))
    r = np.random.RandomState(0)
    x0 = torch.from_numpy(r.randn(3, 20, 64).astype(np.float32))
    mask = torch.ones(3, 20, dtype=torch.int32)
    mask[1, 14:] = 0
    seeds = torch.from_numpy(r.randint(-2 ** 31, 2 ** 31, (2, 2, 3)).astype(np.int32))
    g = torch.from_numpy(r.randn(3, 20, 64).astype(np.float32))

    def run(model, dev):
        x = x0.to(dev).requires_grad_(True)
        out = model(x, mask.to(dev), None, seeds.to(dev), 0.1)
        grads = torch.autograd.grad(out, [x, *model.parameters()], g.to(dev),
                                    allow_unused=True)
        return [out] + [t for t in grads if t is not None]

    ref = run(cpu, "cpu")
    FB.reset_launches()
    ours = run(copy.deepcopy(cpu).to(cuda), cuda)
    torch.cuda.synchronize()
    want = ({"attn_half_full": 2, "attn_half_full_bwd": 2, "dropout": 12}
            if impls[0] == "fused" else
            {"masked_attention": 2, "masked_attention_bwd": 2, "mlp_half_train": 2,
             "mlp_half_train_bwd": 2, "dropout": 4})
    assert FB.launches == {**dict.fromkeys(FB.launches, 0), **want}
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        _close(f"output {i}", a.cpu(), b, 2e-4)


# ----------------------------------------------------- the GEMM sub-kernels
# ln_gemm and gemm_tn (hopper_gemm.cuh in bf16) against _gemm_plain /
# _gemm_tn_plain.  (mode, N, K): the main path's products at C = 768 (qkv,
# fc1 with GELU and dropout, proj and fc2 with the residual, the (K, N) dx
# products g . Wproj, g . W2 with gelu' and dropout, dh . W1 and dqkv . Wqkv
# in fp32), then the op tests' tiny widths (C = 32, 256).  M: the step's
# B S = 16 x 241, serving's 8 x 269, one sample of 269 and 37 rows; rows per
# sample S for the dropout's (row within the sample, column).
GEMM_CASES = [("ln_bias", 2304, 768), ("ln_gelu_aux", 3072, 768),
              ("ln_gelu_aux_drop", 3072, 768), ("bias_res", 768, 768),
              ("bias_res", 768, 3072), ("bias_drop_res", 768, 768),
              ("bias_drop_res", 768, 3072), ("kn", 768, 768), ("kn_dgelu", 3072, 768),
              ("kn_dgelu_drop", 3072, 768), ("kn_f32", 768, 3072), ("kn_f32", 768, 2304),
              ("ln_bias", 96, 32), ("ln_gelu_aux_drop", 128, 32), ("bias_drop_res", 32, 128),
              ("kn_dgelu_drop", 128, 32), ("kn_f32", 32, 96), ("ln_bias", 768, 256),
              ("ln_gelu_aux_drop", 1024, 256), ("bias_drop_res", 256, 1024),
              ("kn_dgelu_drop", 1024, 256), ("kn_f32", 256, 768)]
GEMM_ROWS = [(3856, 241), (2152, 269), (269, 269), (37, 37)]
TN_CASES = [(2304, 768), (768, 768), (3072, 768), (768, 3072), (96, 32), (32, 32),
            (1024, 256), (256, 1024)]


def _gemm_case(mode, M, S, N, K, dev, dtype, seed=0):
    """(kernel kwargs, plain kwargs, a, w, out) for one mode of ln_gemm."""
    r = np.random.RandomState(seed)
    t = lambda *s, dt=dtype, sd=1.0: torch.from_numpy(  # noqa: E731
        (sd * r.randn(*s)).astype(np.float32)).to(dev, dt)
    kn = mode.startswith("kn")
    a, w = t(M, K), t(*((K, N) if kn else (N, K)), sd=0.05)
    kw = dict(w_kn=kn)
    if mode.startswith("ln"):
        kw.update(ln=(t(K, dt=torch.float32, sd=0.1) + 1.0, t(K, dt=torch.float32, sd=0.1)),
                  eps=EPS)
    if not kn:
        kw["bias"] = t(N, dt=torch.float32, sd=0.1)
    if "gelu_aux" in mode:
        kw["gelu"] = True
    if mode.endswith("res"):
        kw["residual"] = t(M, N)
    if "dgelu" in mode:
        kw.update(epi=FB._EPI_DGELU, aux=t(M, N))
    if mode == "kn_f32":
        kw["epi"] = FB._EPI_F32
    plain_kw = dict(kw)
    if "drop" in mode:
        seeds = torch.from_numpy(r.randint(-2 ** 31, 2 ** 31, M // S).astype(np.int32)).to(dev)
        draw = 1 if mode == "bias_drop_res" else 0
        plain_kw["drop"] = (seeds, S, draw, 0.1)
        kw["drop"] = (seeds, S, draw, 0.1, torch.empty(M, N, device=dev, dtype=dtype))
    if "gelu_aux" in mode:
        kw["aux"] = torch.empty(M, N, device=dev, dtype=dtype)
    out = torch.empty(M, N, device=dev, dtype=torch.float32 if mode == "kn_f32" else dtype)
    return kw, plain_kw, a, w, out


def _check_gemm(mode, M, S, N, K, dev, dtype, tol, twice=False):
    """One ln_gemm mode against _gemm_plain; ``twice``: a second call into
    fresh outputs gives the same bits (out, the pre-GELU value, the mask)."""
    from rmcl_tpu_torch.ops import _build
    kw, plain_kw, a, w, out = _gemm_case(mode, M, S, N, K, dev, dtype)
    bias = kw.pop("bias", None)
    plain_kw.pop("bias", None)
    FB._gemm(_build.library(), a, w, bias, out, **kw)
    ref, pre, keep = FB._gemm_plain(a, w, bias, **plain_kw)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and bool(torch.isfinite(out).all())
    _close("out", out, ref, tol)
    if pre is not None:
        _close("pre-GELU aux", kw["aux"], pre, tol)
    if keep is not None:
        assert torch.equal(kw["drop"][4] > 0, keep), "dropout mask differs from keep_mask"
    if twice:
        kw2 = {k: torch.empty_like(v) if k == "aux" and pre is not None else v
               for k, v in kw.items()}
        if keep is not None:
            kw2["drop"] = kw["drop"][:4] + (torch.empty_like(kw["drop"][4]),)
        out2 = torch.empty_like(out)
        FB._gemm(_build.library(), a, w, bias, out2, **kw2)
        torch.cuda.synchronize()
        assert torch.equal(out, out2), "two calls differ"
        if pre is not None:
            assert torch.equal(kw["aux"], kw2["aux"]), "two calls' pre-GELU values differ"
        if keep is not None:
            assert torch.equal(kw["drop"][4], kw2["drop"][4]), "two calls' masks differ"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", GEMM_ROWS, ids=lambda r: f"M{r[0]}")
@pytest.mark.parametrize("mode,N,K", GEMM_CASES, ids=lambda v: str(v))
def test_ln_gemm_kernel_matches_plain(cuda, rows, mode, N, K):
    """The bf16 ln_gemm (LayerNorm pass, TMA + wgmma, epilogue on the
    registers) against _gemm_plain, error relative to max(1, max|ref|) at
    2e-2 as the op tests; the pre-GELU value it keeps likewise; the dropout
    mask it emits equal to philox.keep_mask bit for bit."""
    _check_gemm(mode, *rows, N, K, cuda, torch.bfloat16, 2e-2)


# one sample's 269 rows, and the fp32 parity steps' ragged M (2 x 241, 3 x
# 37), which no 128-row tile divides; their rows per sample place the dropout
F32_ROWS = [(269, 269), (482, 241), (111, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", F32_ROWS, ids=lambda r: f"M{r[0]}")
@pytest.mark.parametrize("mode,N,K", GEMM_CASES, ids=lambda v: str(v))
def test_ln_gemm_fp32_kernel_matches_plain(cuda, rows, mode, N, K):
    """The fp32 dispatch (ln_stats_kernel, then simt_gemm.cuh's FMA kernel):
    summation order only, 2e-4 of max(1, max|ref|), the pre-GELU value
    likewise, the mask equal to keep_mask, and a second call bit for bit."""
    _check_gemm(mode, *rows, N, K, cuda, torch.float32, 2e-4, twice=True)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [r[0] for r in GEMM_ROWS + F32_ROWS[1:]], ids=lambda m: f"M{m}")
@pytest.mark.parametrize("Na,Nb", TN_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_gemm_tn_kernel_matches_plain(cuda, M, Na, Nb, dtype):
    """gemm_tn against a^T . b in fp32: exact products, so only the summation
    order differs (1e-3 of max|ref|; fp32, 2e-4 of max(1, max|ref|)); two
    calls give the same bits, the contraction's slices (where a type's plan
    finds its tiles too few for the SMs: rmcl_gemm_tn_slabs) being added in
    a fixed order."""
    from rmcl_tpu_torch.ops import _build
    r = np.random.RandomState(M + Na + Nb)
    a = torch.from_numpy(r.randn(M, Na).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(r.randn(M, Nb).astype(np.float32)).to(cuda, dtype)
    lib = _build.library()
    assert 1 <= lib.rmcl_gemm_tn_slabs(int(dtype == torch.bfloat16), M, Na, Nb) <= 8
    out, again = FB._gemm_tn(lib, a, b), FB._gemm_tn(lib, a, b)
    ref = FB._gemm_tn_plain(a, b)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (Na, Nb)
    assert torch.equal(out, again)
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 2e-4 * max(1.0, ref.abs().max().item()), err
    assert err <= 1e-3 * ref.abs().max().item(), err


# ------------------------- the bf16 attention backward (csrc/hopper_attention.cuh)
def _packed_case(B, S, H, D, dev, seed, masked_sample=False, first_tile=False):
    """qkv (B, S, 3C) and dattn (B, S, C) in bf16 and a key mask: numpy from
    a seed, the operands of the packed attention backward.  ``first_tile``
    masks every key of the first 64-key tile, a valid key coming later."""
    r = np.random.RandomState(seed)
    C = H * D
    mask = (r.rand(B, S) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if masked_sample:
        mask[-1] = 0
    if first_tile:
        mask[:, :64], mask[:, S - 3] = 0, 1
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    return (t(r.randn(B, S, 3 * C)), torch.from_numpy(mask).to(dev), t(r.randn(B, S, C)))


def _packed_bwd(qkv, mask, dattn, H):
    from rmcl_tpu_torch.ops import _build
    B, S, C3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(B, H, S, 3, device=qkv.device, dtype=torch.float32)
    before = FB.sub_launches["attention_bwd"]
    FB._attn_bwd_packed(_build.library(), qkv, mask, dattn, dqkv, stats, H)
    assert FB.sub_launches["attention_bwd"] == before + 1
    return dqkv


def _check_packed(B, S, H, D, dev, seed, masked_sample=False):
    """The packed core (rows 3, 9, 2: the block halves' rounding points)
    against _attn_dqkv_plain with Wproj the identity, so that dattn = g
    exactly; two calls give the same bits."""
    qkv, mask, dattn = _packed_case(B, S, H, D, dev, seed, masked_sample)
    ours, again = _packed_bwd(qkv, mask, dattn, H), _packed_bwd(qkv, mask, dattn, H)
    eye = torch.eye(H * D, device=dev, dtype=torch.bfloat16)
    ref = FB._attn_dqkv_plain(qkv, mask, eye, dattn, H)
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    _close("dqkv", ours, ref, 2e-2)


def _check_heads(B, S, H, D, dev, seed, packed, masked_sample=False):
    """The heads path (row 11: the attention core's rounding points) against
    masked_attention_bwd_plain, on views of one qkv buffer or contiguous
    copies; two calls give the same bits."""
    from rmcl_tpu_torch.ops import attention as A
    qkv, mask, _ = _packed_case(B, S, H, D, dev, seed, masked_sample)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(B, H, S, D).astype(
        np.float32)).to(dev, torch.bfloat16)
    before = FB.sub_launches["attention_bwd"]
    ours = A.masked_attention_bwd(q, k, v, mask, g, D ** -0.5)
    again = A.masked_attention_bwd(q, k, v, mask, g, D ** -0.5)
    assert FB.sub_launches["attention_bwd"] == before + 2
    ref = A.masked_attention_bwd_plain(q, k, v, mask, g, D ** -0.5)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), ours, again, ref):
        assert torch.equal(a, b), name
        _close(name, a, c, 2e-2)


@pytest.mark.cuda
def test_attention_bwd_packed_at_vilt_shape(cuda):
    """ViLT's own shape, B=16 S=241 H=12 D=64, in bf16."""
    with torch.no_grad():
        _check_packed(16, 241, 12, 64, cuda, 11)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["views", "contiguous"])
def test_attention_bwd_heads_at_vilt_shape(cuda, packed):
    with torch.no_grad():
        _check_heads(16, 241, 12, 64, cuda, 12, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("layout", ["packed", "views", "contiguous"])
def test_attention_bwd_edge_lengths(cuda, S, layout):
    """Sequence lengths around the 64-row tiles, D = 64."""
    with torch.no_grad():
        if layout == "packed":
            _check_packed(3, S, 2, 64, cuda, S)
        else:
            _check_heads(3, S, 2, 64, cuda, S, layout == "views")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "views"])
def test_attention_bwd_fully_masked_sample(cuda, layout):
    """Every key of one sample masked: p is uniform over its S keys, as the
    plain version's finite -1e30 bias gives it, in bf16."""
    with torch.no_grad():
        if layout == "packed":
            _check_packed(2, 70, 4, 64, cuda, 21, masked_sample=True)
        else:
            _check_heads(2, 70, 4, 64, cuda, 21, True, masked_sample=True)


@pytest.mark.cuda
def test_attention_bwd_refuses_unaligned_layouts(cuda):
    """The bf16 backward reads its operands by 16-byte cp.async: a row stride
    that is not a multiple of 8 elements, or a base off 16 bytes, raises
    instead of launching."""
    from rmcl_tpu_torch.ops import attention as A
    B, S, H, D = 2, 70, 4, 64
    C = H * D
    mask = torch.ones(B, S, device=cuda, dtype=torch.int32)
    g = torch.zeros(B, H, S, D, device=cuda, dtype=torch.bfloat16)
    odd = torch.zeros(B, S, 3 * C + 1, device=cuda, dtype=torch.bfloat16)
    q, k, v = odd[..., :3 * C].view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    with torch.no_grad(), pytest.raises(ValueError, match="strides"):
        A.masked_attention_bwd(q, k, v, mask, g, D ** -0.5)
    flat = torch.zeros(B * H * S * D + 1, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(B, H, S, D)
    with torch.no_grad(), pytest.raises(ValueError, match="aligned"):
        A.masked_attention_bwd(q, q, q, mask, g, D ** -0.5)


# ------------------ the fp32 attention kernels (csrc/simt_attention.cuh)
# fwd_kernel and the bwd_dq -> bwd_dkv pair in both layouts against their
# plain versions: S around and past the 32- and 64-row tiles, D in the three
# compiled widths and one that is padded (24); 2e-4 of max(1, max|ref|)
# (summation order only), bit-identical twice.  "first_tile" masks the first
# 64 keys (a valid key comes later), "masked_sample" every key of the last
# sample.
def _f32_case(B, S, H, D, seed, mask_kind="random"):
    r = np.random.RandomState(seed)
    mask = (r.rand(B, S) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if mask_kind == "first_tile":
        mask[:, :64], mask[:, S - 3] = 0, 1
    elif mask_kind == "masked_sample":
        mask[-1] = 0
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32)).cuda()  # noqa: E731
    return t(B, S, 3 * H * D), torch.from_numpy(mask).cuda(), t(B, S, H * D)


def _twice(name, run, out, ref):
    run()
    first = out.clone()
    run()
    torch.cuda.synchronize()
    assert torch.equal(first, out), name
    _close(name, out, ref, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,mask_kind", [(S, D, "random") for S in (1, 31, 63, 64, 65, 241)
                                           for D in (24, 32, 64, 128)]
                         + [(241, 64, "first_tile"), (70, 64, "masked_sample")])
@pytest.mark.parametrize("layout", ["packed", "views", "contiguous"])
def test_attention_fp32_kernels_match_plain(cuda, S, D, mask_kind, layout):
    from rmcl_tpu_torch.ops import _build
    from rmcl_tpu_torch.ops import attention as A
    B, H = 3, 2
    C, scale = H * D, D ** -0.5
    qkv, mask, dattn = _f32_case(B, S, H, D, S + D, mask_kind)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    before = dict(FB.sub_launches)
    if layout == "packed":
        lib = _build.library()
        att, dqkv = torch.empty(B, S, C, device=cuda), torch.empty_like(qkv)
        stats = torch.empty(B, H, S, 3, device=cuda)
        _twice("attn", lambda: FB._attn_fwd_packed(lib, qkv, mask, att, H), att,
               A.mha(q, k, v, mask, scale).transpose(1, 2).reshape(B, S, C))
        _twice("dqkv", lambda: FB._attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, H), dqkv,
               FB._attn_dqkv_plain(qkv, mask, torch.eye(C, device=cuda), dattn, H))
    else:
        if layout == "contiguous":
            q, k, v = (t.contiguous() for t in (q, k, v))
        g = dattn.view(B, S, H, D).transpose(1, 2)
        with torch.no_grad():
            out, again = (A.masked_attention(q, k, v, mask, scale) for _ in range(2))
            grads, grads2 = (A.masked_attention_bwd(q, k, v, mask, g, scale) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        _close("out", out, A.mha(q, k, v, mask, scale), 2e-4)
        for name, a, b, c in zip(("dq", "dk", "dv"), grads, grads2,
                                 A.masked_attention_bwd_plain(q, k, v, mask, g, scale)):
            assert torch.equal(a, b), name
            _close(name, a, c, 2e-4)
    assert FB.sub_launches["attention_fwd"] == before["attention_fwd"] + 2
    assert FB.sub_launches["attention_bwd"] == before["attention_bwd"] + 2


def one_hot_probe(q, k, mask, n, seed):
    """The probe of the fp32 backward's ds (``tests/test_torch_attn_f32.py``):
    make columns c < n of q and k (B, H, S, D) one-hot, in place: q[s0[c], c]
    = 1 and k[t0[c], c] = 1, s0 distinct rows and t0 distinct valid keys of
    each (sample, head).  Then dq[s0[c'], c] and dk[t0[c], c'] are both ds
    at (s0[c'], t0[c]), times scale, each an exact sum of one product and
    zeros.  Returns (s0, t0), (B, H, n) int64."""
    r = np.random.RandomState(seed)
    Bn, Hn, Sn, _ = q.shape
    s0 = np.stack([[r.choice(Sn, n, replace=False) for _ in range(Hn)] for _ in range(Bn)])
    t0 = np.stack([[r.choice(np.flatnonzero(mask[b].cpu().numpy()), n, replace=False)
                    for _ in range(Hn)] for b in range(Bn)])
    s0, t0 = torch.from_numpy(s0).to(q.device), torch.from_numpy(t0).to(q.device)
    at = torch.arange(Sn, device=q.device)[:, None]
    for x, rows in ((q, s0), (k, t0)):       # x may be a view: written in place
        x[..., :n] = (at == rows[:, :, None, :]).to(x.dtype)
    return s0, t0


def probe_ds(dq, dk, s0, t0):
    """ds at the (s0[c'], t0[c]) pairs, (B, H, n c', n c), as dq and as dk
    hold it: dq[s0[c'], c] and dk[t0[c], c']."""
    n, D = s0.shape[-1], dq.shape[-1]
    at_q = dq.gather(2, s0[..., None].expand(-1, -1, -1, D))[..., :n]
    at_k = dk.gather(2, t0[..., None].expand(-1, -1, -1, D))[..., :n]
    return at_q, at_k.transpose(-1, -2)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(241, 64), (65, 32), (217, 128)])
@pytest.mark.parametrize("layout", ["packed", "heads"])
def test_attention_fp32_backward_kernels_give_one_ds(cuda, S, D, layout):
    """bwd_dq_kernel and bwd_dkv_kernel each recompute s, p, dp and ds from
    q, k, v, g and the stats: the probe reads ds from dq (bwd_dq) and from
    dk (bwd_dkv) at 16 x 16 (query, key) pairs of every (sample, head), equal
    bit for bit, as the scores and dp summed over d in one order make them."""
    from rmcl_tpu_torch.ops import _build
    from rmcl_tpu_torch.ops import attention as A
    B, H = 2, 3
    qkv, mask, dattn = _f32_case(B, S, H, D, S + D + 1)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    s0, t0 = one_hot_probe(q, k, mask, 16, S)
    if layout == "packed":
        dqkv, stats = torch.empty_like(qkv), torch.empty(B, H, S, 3, device=cuda)
        FB._attn_bwd_packed(_build.library(), qkv, mask, dattn, dqkv, stats, H)
        dq, dk = dqkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)[:2]
    else:
        g = dattn.view(B, S, H, D).transpose(1, 2)
        with torch.no_grad():
            dq, dk, _ = A.masked_attention_bwd(q, k, v, mask, g, D ** -0.5)
    at_q, at_k = probe_ds(dq, dk, s0, t0)
    torch.cuda.synchronize()
    assert torch.equal(at_q, at_k) and bool((at_q != 0).any()), (at_q - at_k).abs().max()


@pytest.mark.cuda
def test_attention_fp32_kernels_take_odd_strides(cuda):
    """q, k, v as views of a (B, S, 3C + 1) buffer: row strides that are not
    multiples of 4 floats, which the kernels copy 4 bytes at a time."""
    from rmcl_tpu_torch.ops import attention as A
    B, S, H, D = 2, 70, 4, 64
    C, scale = H * D, D ** -0.5
    r = np.random.RandomState(4)
    buf = torch.from_numpy(r.randn(B, S, 3 * C + 1).astype(np.float32)).cuda()
    q, k, v = buf[..., :3 * C].unflatten(-1, (3, H, D)).permute(2, 0, 3, 1, 4).unbind(0)
    mask = torch.from_numpy((r.rand(B, S) > 0.3).astype(np.int32)).cuda()
    mask[:, 0] = 1
    g = torch.from_numpy(r.randn(B, H, S, D).astype(np.float32)).cuda()
    with torch.no_grad():
        _close("out", A.masked_attention(q, k, v, mask, scale), A.mha(q, k, v, mask, scale),
               2e-4)
        for name, a, c in zip(("dq", "dk", "dv"), A.masked_attention_bwd(q, k, v, mask, g, scale),
                              A.masked_attention_bwd_plain(q, k, v, mask, g, scale)):
            _close(name, a, c, 2e-4)


# --------------------------- the bf16 attention forward (csrc/hopper_attention.cuh)
def _close_to_max(name, out, ref, tol):
    """Error relative to max|ref| of that output."""
    out, ref = out.float(), ref.float()
    assert bool(torch.isfinite(out).all()), name
    err = (out - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (name, err)


def _packed_fwd(qkv, mask, H):
    from rmcl_tpu_torch.ops import _build
    B, S, C3 = qkv.shape
    attn = torch.empty(B, S, C3 // 3, device=qkv.device, dtype=qkv.dtype)
    before = FB.sub_launches["attention_fwd"]
    FB._attn_fwd_packed(_build.library(), qkv, mask, attn, H)
    assert FB.sub_launches["attention_fwd"] == before + 1
    return attn


def _fwd_plain(qkv, mask, H):
    """The plain packed forward: mha on the heads of qkv, merged to (B, S, C)."""
    from rmcl_tpu_torch.ops import attention as A
    B, S, C3 = qkv.shape
    D = C3 // 3 // H
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    return A.mha(q, k, v, mask, D ** -0.5).transpose(1, 2).reshape(B, S, C3 // 3)


def _check_fwd_packed(B, S, H, D, dev, seed, **mask_kind):
    """The packed forward (rows 1, 8, 2: the block halves' attention) against
    mha on the same heads, 2e-2 of max|ref|; two calls give the same bits."""
    qkv, mask, _ = _packed_case(B, S, H, D, dev, seed, **mask_kind)
    ours, again = _packed_fwd(qkv, mask, H), _packed_fwd(qkv, mask, H)
    ref = _fwd_plain(qkv, mask, H)
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    _close_to_max("attn", ours, ref, 2e-2)


def _check_fwd_heads(B, S, H, D, dev, seed, packed, **mask_kind):
    """The heads path (row 10) against mha, on views of one qkv buffer or
    contiguous copies; two calls give the same bits."""
    from rmcl_tpu_torch.ops import attention as A
    qkv, mask, _ = _packed_case(B, S, H, D, dev, seed, **mask_kind)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = FB.sub_launches["attention_fwd"]
    ours = A.masked_attention(q, k, v, mask, D ** -0.5)
    again = A.masked_attention(q, k, v, mask, D ** -0.5)
    assert FB.sub_launches["attention_fwd"] == before + 2
    ref = A.mha(q, k, v, mask, D ** -0.5)
    torch.cuda.synchronize()
    assert ours.shape == q.shape and ours.dtype == torch.bfloat16
    assert torch.equal(ours, again)
    _close_to_max("out", ours, ref, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(16, 241), (8, 269)], ids=["step", "serving"])
@pytest.mark.parametrize("layout", ["packed", "views", "contiguous"])
def test_attention_fwd_at_vilt_shapes(cuda, B, S, layout):
    """ViLT's own shapes, H=12 D=64, in bf16: the step's and serving's."""
    with torch.no_grad():
        if layout == "packed":
            _check_fwd_packed(B, S, 12, 64, cuda, 31)
        else:
            _check_fwd_heads(B, S, 12, 64, cuda, 32, layout == "views")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 241, 269])
@pytest.mark.parametrize("layout", ["packed", "views", "contiguous"])
def test_attention_fwd_edge_lengths(cuda, S, layout):
    """Sequence lengths around the 64-row tiles and ViLT's ragged ones, D = 64."""
    with torch.no_grad():
        if layout == "packed":
            _check_fwd_packed(3, S, 2, 64, cuda, S)
        else:
            _check_fwd_heads(3, S, 2, 64, cuda, S, layout == "views")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"S{s[1]}C{s[2]}H{s[3]}{s[4]}")
@pytest.mark.parametrize("layout", ["packed", "views", "contiguous"])
def test_attention_fwd_head_dims(cuda, shape, layout):
    """D = 8, 64 and 128 (padded to 64 or 128 columns) at SHAPES' sizes."""
    B, S, C, H, kind = shape
    with torch.no_grad():
        if layout == "packed":
            _check_fwd_packed(B, S, H, C // H, cuda, 41, first_tile=kind == "first_tile")
        else:
            _check_fwd_heads(B, S, H, C // H, cuda, 42, layout == "views",
                             first_tile=kind == "first_tile")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["first_tile", "masked_sample"])
@pytest.mark.parametrize("layout", ["packed", "views"])
def test_attention_fwd_masked_tiles(cuda, kind, layout):
    """Every key of the first tile masked, a valid key later (the running
    sums rescale to 0); every key of one sample masked (p uniform over its S
    keys, as the plain version's finite -1e30 bias gives it)."""
    mask_kind = {kind: True}
    with torch.no_grad():
        if layout == "packed":
            _check_fwd_packed(2, 241, 4, 64, cuda, 51, **mask_kind)
        else:
            _check_fwd_heads(2, 241, 4, 64, cuda, 52, True, **mask_kind)


@pytest.mark.cuda
def test_attention_fwd_fp32_stays_simt(cuda):
    """fp32 runs the SIMT forward (wgmma would read TF32): any strides, and
    no bf16 sub-launch counted."""
    from rmcl_tpu_torch.ops import attention as A
    B, S, H, D = 2, 70, 4, 64
    r = np.random.RandomState(61)
    odd = torch.from_numpy(r.randn(B, S, 3 * H * D + 1).astype(np.float32)).to(cuda)
    q, k, v = odd[..., :3 * H * D].view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    mask = torch.ones(B, S, device=cuda, dtype=torch.int32)
    before = dict(FB.sub_launches)
    with torch.no_grad():
        out = A.masked_attention(q, k, v, mask, D ** -0.5)
    torch.cuda.synchronize()
    assert FB.sub_launches == before
    _close("out", out, A.mha(q, k, v, mask, D ** -0.5), 2e-4)


@pytest.mark.cuda
def test_attention_fwd_refuses_unaligned_layouts(cuda):
    """The bf16 forward reads its operands by 16-byte cp.async: a row stride
    that is not a multiple of 8 elements, a base off 16 bytes or a head dim
    that is not a multiple of 8 raises instead of launching."""
    from rmcl_tpu_torch.ops import _build
    from rmcl_tpu_torch.ops import attention as A
    B, S, H, D = 2, 70, 4, 64
    C = H * D
    mask = torch.ones(B, S, device=cuda, dtype=torch.int32)
    odd = torch.zeros(B, S, 3 * C + 1, device=cuda, dtype=torch.bfloat16)
    q, k, v = odd[..., :3 * C].view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    before = FB.sub_launches["attention_fwd"]
    with torch.no_grad(), pytest.raises(ValueError, match="strides"):
        A.masked_attention(q, k, v, mask, D ** -0.5)
    flat = torch.zeros(B * H * S * D + 1, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(B, H, S, D)
    with torch.no_grad(), pytest.raises(ValueError, match="aligned"):
        A.masked_attention(q, q, q, mask, D ** -0.5)
    q = torch.zeros(B, H, S, 12, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="multiple of 8"):
        A.masked_attention(q, q, q, mask, 12 ** -0.5)
    qkv = torch.zeros(B, S, 3 * H * 12, device=cuda, dtype=torch.bfloat16)
    attn = torch.empty(B, S, H * 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        FB._attn_fwd_packed(_build.library(), qkv, mask, attn, H)
    assert FB.sub_launches["attention_fwd"] == before


# ------------- the LayerNorm backward and the bias-gradient column sums
# ln_bwd (one warp per row, dx-only and training forms) and colsum (clusters
# of 8 CTAs along the rows) against _ln_backward_plain / _colsum_plain.
# Widths: C = 768, a narrow one and one with a ragged 256-column chunk; rows:
# 74 (one cluster, idle CTAs), the step's 3,856, and 5,000 (more row blocks
# than the training form's 256 CTAs, so CTAs walk several).
LN_WIDTHS = [32, 264, 768]
LN_ROWS = [74, 3856, 5000]


def _bf16_ulp(v):
    """One bf16 ulp of the value v > 0: 2^(exponent - 7)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _close_out(name, out, ref, dtype):
    """fp32: summation order only, 1e-5 of max(1, max|ref|); bf16 outputs
    rounded from fp32 values that differ in summation order: one bf16 ulp of
    max|ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if dtype == torch.float32 else _bf16_ulp(ref_max)
    assert err <= tol, (name, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("M", LN_ROWS, ids=lambda m: f"M{m}")
@pytest.mark.parametrize("C", LN_WIDTHS, ids=lambda c: f"C{c}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("train", [False, True], ids=["dx", "train"])
@pytest.mark.parametrize("residual", [True, False], ids=["g", "nog"])
def test_ln_bwd_kernel_matches_plain(cuda, M, C, dtype, train, residual):
    """ln_bwd against _ln_backward_plain: dx (and in the training form y in
    x's type, dln_w and dln_b in fp32, 1e-5 of max(1, max|ref|)); two calls
    give the same bits; one launch each, counted under ``ln_bwd``."""
    from rmcl_tpu_torch.ops import _build
    r = np.random.RandomState(M + C)
    t = lambda *s, dt=torch.float32, sd=1.0, mu=0.0: torch.from_numpy(  # noqa: E731
        (mu + sd * r.randn(*s)).astype(np.float32)).to(cuda, dt)
    x, dy, g = t(M, C, dt=dtype, sd=2.0, mu=0.5), t(M, C), t(M, C, dt=dtype)
    ln_w, ln_b = t(C, sd=0.1, mu=1.0), t(C, sd=0.1)
    lib = _build.library()
    ref = FB._ln_backward_plain(x, dy, ln_w, ln_b, g, EPS, residual)
    before = FB.sub_launches["ln_bwd"]
    if train:
        out = FB._ln_backward(lib, x, dy, ln_w, ln_b, g, EPS, residual)
        again = FB._ln_backward(lib, x, dy, ln_w, ln_b, g, EPS, residual)
    else:
        out = (FB._ln_bwd_dx(lib, x, dy, ln_w, g, EPS, residual),)
        again = (FB._ln_bwd_dx(lib, x, dy, ln_w, g, EPS, residual),)
    torch.cuda.synchronize()
    assert FB.sub_launches["ln_bwd"] == before + 2
    for name, o, o2, want in zip(("dx", "y", "dln_w", "dln_b"), out, again, ref):
        assert o.dtype == want.dtype and o.shape == want.shape, name
        assert bool(torch.isfinite(o).all()), name
        assert torch.equal(o, o2), f"{name} differs between two calls"
        _close_out(name, o, want, dtype if name in ("dx", "y") else torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [5, 74, 3856], ids=lambda m: f"M{m}")
@pytest.mark.parametrize("N", [8, 768, 776, 2304, 3072], ids=lambda n: f"N{n}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_colsum_kernel_matches_plain(cuda, M, N, dtype):
    """colsum against a.float().sum(0): the summation order only, 1e-5 of
    max(1, max|ref|); N = 776 leaves a ragged 64-column strip, M = 5 ranks
    with no rows; two calls give the same bits; one launch each."""
    from rmcl_tpu_torch.ops import _build
    r = np.random.RandomState(M + N)
    a = torch.from_numpy((0.5 + r.randn(M, N)).astype(np.float32)).to(cuda, dtype)
    lib = _build.library()
    before = FB.sub_launches["colsum"]
    out, again = FB._colsum(lib, a), FB._colsum(lib, a)
    ref = FB._colsum_plain(a)
    torch.cuda.synchronize()
    assert FB.sub_launches["colsum"] == before + 2
    assert out.dtype == torch.float32 and out.shape == (N,)
    assert torch.equal(out, again)
    _close_out("colsum", out, ref, torch.float32)


@pytest.mark.cuda
def test_ln_bwd_and_colsum_refuse_what_they_do_not_take(cuda):
    """A row wider than the kernel's registers hold, or widths that are not
    multiples of 8, raise instead of launching."""
    from rmcl_tpu_torch.ops import _build
    lib = _build.library()
    wide = lib.rmcl_ln_bwd_max_width() + 8
    x = torch.zeros(4, wide, device=cuda, dtype=torch.bfloat16)
    dy = torch.zeros(4, wide, device=cuda)
    ln = torch.ones(wide, device=cuda)
    before = dict(FB.sub_launches)
    with pytest.raises(ValueError, match="at most"):
        FB._ln_bwd_dx(lib, x, dy, ln, x, EPS, True)
    with pytest.raises(ValueError, match="at most"):
        FB._ln_backward(lib, x, dy, ln, ln, x, EPS, True)
    with pytest.raises(ValueError, match="multiple of 8"):
        FB._colsum(lib, torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16))
    assert FB.sub_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backward_ops_launch_ln_bwd_and_colsum(cuda, dtype):
    """Every dx and full backward runs one ln_bwd; every full backward two
    colsum (its two bias gradients)."""
    B, S, C, H, kind = SHAPES[1]
    attn, mlp = _inputs(B, S, C, H, kind, cuda, dtype)
    x, mask, lw, lb, wq, bq, wp, bp = attn[:8]
    w1, b1, w2, b2 = mlp[3:7]
    g = torch.randn(B, S, C, device=cuda).to(dtype)
    seeds = _seeds(B, cuda)
    with torch.no_grad():
        _, qkv, att = FB._attn_fwd(x, mask, lw, lb, wq, bq, wp, bp, H, EPS, True)
        h, a_d = FT._mlp_train_fwd(x, seeds, lw, lb, w1, b1, w2, b2, EPS, 0.1, True)[1:3]
        calls = {
            "attn_half_dx": lambda: FB.attn_half_dx(x, mask, lw, lb, wq, bq, wp, g, H, EPS),
            "mlp_half_dx": lambda: FB.mlp_half_dx(x, lw, lb, w1, b1, w2, g, EPS),
            "attn_half_full_bwd": lambda: FB.attn_half_full_bwd(x, mask, lw, lb, wq, wp, g,
                                                                qkv, att, H, EPS),
            "attn_half_train_bwd": lambda: FT.attn_half_train_bwd(
                x, seeds, mask, lw, lb, wq, wp, g, qkv, att, H, EPS, 0.1),
            "mlp_half_train_bwd": lambda: FT.mlp_half_train_bwd(
                x, seeds, lw, lb, w1, w2, g, h, a_d, 0.1, EPS),
        }
        for name, call in calls.items():
            before = dict(FB.sub_launches)
            call()
            torch.cuda.synchronize()
            full = not name.endswith("_dx")
            assert FB.sub_launches["ln_bwd"] == before["ln_bwd"] + 1, name
            assert FB.sub_launches["colsum"] == before["colsum"] + (2 if full else 0), name


# -------------------------------------------------- the greedy text attack
GREEDY_WORDS = ["dog", "cat", "puppy", "kitten", "car", "auto", "red", "crimson", "blue",
                "big", "large", "small", "tiny", "runs", "sprints", "sits", "park",
                "garden", "street", "road", "in", "the", "a", "on"]
GREEDY_GROUPS = [["dog", "puppy"], ["cat", "kitten"], ["car", "auto"], ["red", "crimson"],
                 ["big", "large"], ["small", "tiny"], ["runs", "sprints"],
                 ["park", "garden"], ["street", "road"]]
GREEDY_SENTENCES = ["dog runs in park", "cat sits in street", "big red car on road",
                    "the a on in", "small puppy sits on the big road"]


def _greedy_case(tmp_path, dtype):
    """A seeded 3-layer moco model (C = 64) on the CPU, the tiny vocabulary
    and synonym table of tests/test_attacks.py, five captions and keys."""
    from rmcl_tpu_torch.attacks.greedy import SynonymTable
    from rmcl_tpu_torch.core.config import build_config, loss_names
    from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer, make_tiny_vocab
    from rmcl_tpu_torch.objectives.losses import l2_normalize
    from rmcl_tpu_torch.serve import seeded_model
    tok = WordPieceTokenizer(make_tiny_vocab(str(tmp_path / "vocab.txt"), GREEDY_WORDS))
    r = np.random.RandomState(0)
    vecs = {w: base + 0.05 * r.randn(16) for group in GREEDY_GROUPS
            for base in [r.randn(16)] for w in group}
    vecs.update({w: r.randn(16) for w in GREEDY_WORDS if w not in vecs})
    with open(tmp_path / "vectors.txt", "w") as f:
        for w, v in vecs.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    cfg = build_config(hidden_size=64, num_heads=2, num_layers=3, patch_size=16,
                       image_size=32, image_bucket_hw=(32, 48), max_text_len=16,
                       vocab_size=tok.vocab_size, loss_names=loss_names({"moco": 1}),
                       num_negative=32, temperature=0.07, n_candidates=3, max_loops=3,
                       compute_dtype=str(dtype).split(".")[1], max_image_len=4)
    syn = SynonymTable(str(tmp_path / "vectors.txt"), cfg.n_candidates, cfg.sim_thred)
    model = seeded_model(cfg, 0).eval()
    ids, masks = tok.batch_encode(GREEDY_SENTENCES, cfg.max_text_len)
    img = np.zeros((len(ids), 6, 768), np.float32)
    img[:, :5] = r.uniform(-1, 1, (len(ids), 5, 768))
    batch = {"image": torch.from_numpy(img), "text_ids": torch.from_numpy(ids),
             "text_masks": torch.from_numpy(masks)}
    with torch.no_grad():
        k = l2_normalize(model.k_moco_head(model.infer_k(batch)["cls_feats"]), 1)
    return cfg, tok, syn, model, batch, k


def _attack_launches(stats, num_layers):
    """Block-op launches of an attack that ran ``stats`` (last_stats)."""
    g, s = stats["grad_passes"], stats["score_forwards"]
    return {**dict.fromkeys(FB.launches, 0), "attn_half": num_layers * (g + s),
            "mlp_half": num_layers * (g + s), "attn_half_dx": num_layers * g,
            "mlp_half_dx": num_layers * g}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_greedy_attack_on_card(cuda, tmp_path, dtype):
    """The fused greedy attack on the card (kernels) against the CPU (plain
    ops) from the same weights, captions and keys: in fp32 the same ids and
    change counts; in bf16 every substitution a candidate of its word and
    within the budget.  The block ops' launch counters equal what the attack
    reports (loops, gradient passes, scoring forwards), and the sub-kernel
    counters follow the ops'."""
    import copy
    from rmcl_tpu_torch.attacks.greedy import GreedyAttackMoco
    from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
    cfg, tok, syn, cpu, batch, k = _greedy_case(tmp_path, dtype)
    extras = (k, cpu.proj_queue, cfg.temperature)
    ref = FusedGreedyAttack(GreedyAttackMoco(cfg, cpu, tok, syn)).adv_attack_samples(
        batch, extras)
    gpu = copy.deepcopy(cpu).to(cuda)
    att = FusedGreedyAttack(GreedyAttackMoco(cfg, gpu, tok, syn))
    FB.reset_launches()
    ours = att.adv_attack_samples({n: v.to(cuda) for n, v in batch.items()},
                                  (k.to(cuda), gpu.proj_queue, cfg.temperature))
    torch.cuda.synchronize()
    assert FB.launches == _attack_launches(att.last_stats, cfg.num_layers)
    s = att.last_stats
    assert s["host_reads"] == s["loops"] + 1 and s["grad_passes"] >= 1
    if dtype == torch.bfloat16:
        ops = dict(FB.launches)
        assert FB.sub_launches["ln_gemm"] == 2 * sum(ops.values())
        assert FB.sub_launches["attention_fwd"] == ops["attn_half"]
        assert FB.sub_launches["attention_bwd"] == ops["attn_half_dx"]
        assert FB.sub_launches["ln_bwd"] == ops["attn_half_dx"] + ops["mlp_half_dx"]
    if dtype == torch.float32:
        np.testing.assert_array_equal(ours["txt_input_ids"], ref["txt_input_ids"])
        assert ours["changes_verification"] == ref["changes_verification"]
    assert ours["num_changes"] > 0
    lens = batch["text_masks"].sum(1).tolist()
    for orig, new, n, L in zip(GREEDY_SENTENCES, ours["text"], ours["changes_verification"],
                               lens):
        changed = [(o, w) for o, w in zip(orig.split(), new.split()) if o != w]
        assert all(w in syn.candidates(o) for o, w in changed), (orig, new)
        assert len(changed) == n <= min(int(0.2 * (L - 1)), cfg.max_loops)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
def test_halves_at_the_greedy_scoring_shape(cuda, dtype, tol):
    """attn_half and mlp_half, and their dx ops, at the greedy attack's
    scoring batch of the main path: B = 16 pairs x 5 candidates = 80 rows,
    S = 16 + 201 = 217 (text bucket 16), C = 768, H = 12."""
    attn, mlp = _inputs(80, 217, 768, 12, "random", cuda, dtype, seed=4)
    g = torch.randn(80, 217, 768, device=cuda).to(dtype)
    with torch.inference_mode():
        for op, plain, args in ((FB.attn_half, FB.attn_half_plain, attn),
                                (FB.mlp_half, FB.mlp_half_plain, mlp)):
            _close(op.__name__, op(*args), plain(*args), tol)
        dx_attn = (*attn[:7], g, *attn[8:])
        dx_mlp = (*mlp[:6], g, mlp[7])
        for op, plain, args in ((FB.attn_half_dx, FB.attn_half_dx_plain, dx_attn),
                                (FB.mlp_half_dx, FB.mlp_half_dx_plain, dx_mlp)):
            _close(op.__name__, op(*args), plain(*args), tol)
