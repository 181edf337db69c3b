"""The CUDA block kernels (rmcl_tpu_torch/csrc/block_kernels.cu), forward
and dx-only backward, against their plain versions, and one PGD step, on the
card.  Every case is marked ``cuda`` and skips
where there is no CUDA device.  This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rmcl_tpu_torch.ops import fused_block as FB

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
    assert FB.launches == {"attn_half": 1, "mlp_half": 1,
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
    assert FB.launches == {"attn_half": 3, "mlp_half": 3, "attn_half_dx": 3, "mlp_half_dx": 3}
    assert ref.abs().max().item() > 0
    assert (ours.cpu() - ref).abs().max().item() <= 1e-5
