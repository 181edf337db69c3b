"""Masked multi-head self-attention on (B, H, S, D) operands: the plain
version (port of ``rmcl_tpu/ops/attention.py:mha_xla``) and the attention
core of the unfused block as an op with its backward.

Ports of ``rmcl_tpu/ops/pallas_attention.py``:
  * ``masked_attention`` <- ``flash_masked_attention``: forward ``_fwd_impl``
    (``_attn_kernel``), backward ``_bwd_impl`` (``_attn_bwd_kernel``).  It also
    serves ``rmcl_tpu/ops/attention.py:mha_jax_flash``, which computes the same
    function on every row that is read.

Scores are q . k^T * scale in fp32, keys with mask == 0 get a -1e30 bias
(a finite sentinel: a fully masked row stays finite), softmax in fp32, and
the probabilities are rounded to v's type before P . V, which accumulates in
fp32.  The backward follows ``_attn_bwd_kernel``'s rounding points, which are
not those of the block halves' backward (``fused_block.py``): g and v enter
in fp32, ds = p (dp - sum dp p) stays fp32 and unscaled, ``scale`` multiplies
the fp32 products ds . k and ds^T . q, and dv = p^T . g takes the fp32 p.  In
fp32 the two sets of points coincide.

On a CUDA tensor ``masked_attention`` is a ``torch.autograd.Function`` whose
forward and backward launch the kernels of ``csrc/block_kernels.cu``
(``rmcl_attention_fwd`` / ``rmcl_attention_bwd``: the block halves'
attention kernels with explicit strides and these rounding points), or
raise; on a CPU tensor that needs a gradient it is ``mha`` under autograd.
The forward is the ``torch.library`` operator ``rmcl::masked_attention``
(CUDA kernel the launch, CPU kernel ``mha``, as ``fused_block.py`` says
why), which the Function and the no-gradient call both go through.  The kernels read q, k
and v through their strides (views of one qkv buffer need no copy) and write
the output as (B, S, H, D) memory, so that merging the heads back to
(B, S, C) is a view.  Launches count in ``fused_block.launches`` under
``masked_attention`` and ``masked_attention_bwd``, and the kernels in
``fused_block.sub_launches`` under ``attention_fwd`` and ``attention_bwd``.
In bfloat16 the forward and the backward run the wgmma kernels of
``csrc/hopper_attention.cuh``, which read q, k, v and g by cp.async: their
head dim a multiple of 8, their bases 16-byte aligned and their (b, h, s)
strides multiples of 8 elements, or it raises; in float32 the register-tiled
FMA kernels of ``csrc/simt_attention.cuh`` (no TF32), which take any strides
(16-byte copies where bases and strides allow, else 4-byte ones).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from rmcl_tpu_torch.ops import _build

NEG_BIAS = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
        scale: float) -> torch.Tensor:
    """q, k, v: (B, H, S, D); mask: (B, S), 1 = valid key.  Returns (B, H, S, D)."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG_BIAS)
    probs = torch.softmax(scores + bias, dim=-1)
    out = probs.to(v.dtype).float() @ v.float()
    return out.to(v.dtype)


def masked_attention_bwd_plain(q, k, v, mask, g, scale: float):
    """(dq, dk, dv) of ``mha`` given the output gradient g, step by step with
    the rounding points of ``pallas_attention.py:_attn_bwd_kernel``."""
    dt = q.dtype
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    scores = (q32 @ k32.transpose(-1, -2)) * scale
    scores = scores + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_BIAS)
    e = torch.exp(scores - scores.max(-1, keepdim=True).values)
    p = e / e.sum(-1, keepdim=True)                       # (B, H, S, S) fp32
    dp = g32 @ v32.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))        # fp32, unscaled
    return ((scale * (ds @ k32)).to(dt), (scale * (ds.transpose(-1, -2) @ q32)).to(dt),
            (p.transpose(-1, -2) @ g32).to(dt))


# ----------------------------------------------------------- kernel launchers
def _strides(t):
    return t.stride()[:3]


def _operands(q, k, v, mask):
    """Check what the kernels take.  q, k and v are passed as they are when
    they share one stride set with d contiguous (views of one qkv buffer),
    else as contiguous copies."""
    B, H, S, D = q.shape
    if q.device.type != "cuda":
        raise RuntimeError(f"masked_attention takes CPU or CUDA tensors, got {q.device}")
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError("q, k, v and mask must lie on one device")
    if q.dtype not in _DTYPE_CODE or not k.dtype == v.dtype == q.dtype:
        raise TypeError(f"q, k, v must share a type, float32 or bfloat16: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {_MAX_HEAD_DIM}")
    if mask.dtype != torch.int32 or tuple(mask.shape) != (B, S) or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous (B, S) = {(B, S)} int32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if q.stride(3) != 1 or not q.stride() == k.stride() == v.stride():
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _attention_fwd(q, k, v, mask, scale):
    """The forward kernel: the output as contiguous (B, S, H, D) memory."""
    from rmcl_tpu_torch.ops.fused_block import launches, sub_launches  # imports this one
    B, H, S, D = q.shape
    if q.dtype == torch.bfloat16:
        _wgmma_layout(q=q, k=k, v=v)
    out = torch.empty(B, S, H, D, device=q.device, dtype=q.dtype)
    heads = out.transpose(1, 2)
    rc = _build.library().rmcl_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), *_strides(q),
        mask.data_ptr(), heads.data_ptr(), *_strides(heads), B, S, H, D, scale, _stream(q))
    _build.check(rc, "attention_fwd")
    launches["masked_attention"] += 1
    sub_launches["attention_fwd"] += 1
    return out


def _wgmma_layout(**tensors):
    """What the bf16 attention kernels read and write by cp.async and paired
    stores: a head dim that is a multiple of 8, 16-byte aligned bases and
    (b, h, s) strides that are multiples of 8 elements.  Raises on anything
    else."""
    D = tensors["q"].shape[-1]
    if D % 8:
        raise ValueError(f"head dim {D} must be a multiple of 8 for the bf16 attention "
                         f"kernels")
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{name}: the bf16 attention kernels need a 16-byte aligned "
                             f"base and (b, h, s) strides that are multiples of 8, got "
                             f"strides {tuple(t.stride())}")


def _attention_bwd(q, k, v, mask, g, scale):
    from rmcl_tpu_torch.ops.fused_block import launches, sub_launches  # imports this one
    B, H, S, D = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.stride(3) != 1:
        g = g.to(q.dtype).contiguous()
    if q.dtype == torch.bfloat16:
        _wgmma_layout(q=q, k=k, v=v, g=g)
    # dq, dk, dv as views of one (B, S, 3, H, D) buffer: the layout of the qkv
    # projection they flow back into
    d = torch.empty(B, S, 3, H, D, device=q.device, dtype=q.dtype).permute(2, 0, 3, 1, 4)
    dq, dk, dv = d.unbind(0)
    stats = torch.empty(B, H, S, 3, device=q.device, dtype=torch.float32)
    rc = _build.library().rmcl_attention_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), *_strides(q),
        mask.data_ptr(), g.data_ptr(), *_strides(g), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_strides(dq), stats.data_ptr(), B, S, H, D, scale, _stream(q))
    _build.check(rc, "attention_bwd")
    launches["masked_attention_bwd"] += 1
    sub_launches["attention_bwd"] += 1
    return dq, dk, dv


def masked_attention_bwd(q, k, v, mask, g, scale: float):
    """(dq, dk, dv) of ``masked_attention`` given its output gradient g:
    plain on the CPU, the kernels on CUDA."""
    if q.device.type == "cpu":
        return masked_attention_bwd_plain(q, k, v, mask, g, scale)
    q, k, v = _operands(q, k, v, mask)
    return _attention_bwd(q, k, v, mask, g, scale)


# The forward as a ``torch.library`` operator (``fused_block.py`` says why and
# how it is registered): rmcl::masked_attention returns the output as
# contiguous (B, S, H, D), the layout the kernel writes, and
# ``masked_attention`` hands out its (B, H, S, D) view.  The CPU kernel is
# ``mha``, the CUDA kernel the launch above.
_LIB = torch.library.Library("rmcl", "FRAGMENT")
_LIB.define("masked_attention(Tensor q, Tensor k, Tensor v, Tensor mask, float scale) -> Tensor")


def _masked_attention_cpu(q, k, v, mask, scale):
    return mha(q, k, v, mask, scale).transpose(1, 2).contiguous()


def _masked_attention_cuda(q, k, v, mask, scale):
    q, k, v = _operands(q, k, v, mask)
    return _attention_fwd(q, k, v, mask, scale)


_LIB.impl("masked_attention", _masked_attention_cpu, "CPU")
_LIB.impl("masked_attention", _masked_attention_cuda, "CUDA")


@torch.library.register_fake("rmcl::masked_attention", lib=_LIB)
def _(q, k, v, mask, scale):
    B, H, S, D = q.shape
    return q.new_empty(B, S, H, D)


_masked_attention_op = torch.ops.rmcl.masked_attention.default


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        q, k, v = _operands(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        return _masked_attention_op(q, k, v, mask, scale).transpose(1, 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        return (*_attention_bwd(q, k, v, mask, g, ctx.scale), None, None)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Masked attention of q, k, v (B, H, S, D) under the key mask (B, S),
    differentiable with respect to q, k and v."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"masked_attention takes CPU or CUDA tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cpu":
            return mha(q, k, v, mask, scale)
        return _MaskedAttention.apply(q, k, v, mask, scale)
    return _masked_attention_op(q, k, v, mask, scale).transpose(1, 2)
