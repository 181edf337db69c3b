"""The CUDA block kernels (rmcl_tpu_torch/csrc/block_kernels.cu) against
their plain versions, on the card.  Every case is marked ``cuda`` and skips
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
def test_kernels_refuse_grad_and_bad_layouts(cuda):
    attn, _ = _inputs(*SHAPES[0], cuda, torch.float32)
    args = list(attn)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        FB.attn_half(*args)
    args[0] = attn[0]
    args[4] = args[4].t()            # a (C, 3C) view: not the kernel's layout
    with torch.inference_mode(), pytest.raises(ValueError):
        FB.attn_half(*args)
    args[4] = attn[4].to(torch.bfloat16)
    with torch.inference_mode(), pytest.raises(TypeError):
        FB.attn_half(*args)
