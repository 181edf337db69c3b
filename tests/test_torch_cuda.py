"""The CUDA block kernels (rmcl_tpu_torch/csrc/block_kernels.cu), forward
and dx-only backward, and the training forward and full backward, against
their plain versions; one PGD step and one training step, on the card.  Every case is marked ``cuda`` and skips
where there is no CUDA device.  This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

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
