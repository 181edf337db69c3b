"""Philox-4x32-10 in plain torch, and the dropout keep mask drawn from it.

Counterpart of the in-kernel random bits of the JAX package's training
kernels (``rmcl_tpu/ops/pallas_block.py``: ``pltpu.prng_seed`` /
``prng_random_bits`` in ``_mlp_train_kernel`` and ``_attn_train_kernel``).
Those bits come from the TPU's own generator; here they come from the
counter-based Philox-4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11), so the stream is this implementation's own.  What
is carried over is the rule: one 32-bit word per element, keep iff
``bits >= T`` with ``T = min(round(p * 2**32), 2**32 - 1)``
(``_keep_threshold``), kept values scaled by ``1 / (1 - p)``.

The word of element (sample b, row r, column c) of draw d is word 0 of
``philox(counter=(c, r, d, 0), key=(seed[b], 0))`` with the per-sample int32
seed read as uint32.  It depends on nothing else: no tile, launch or batch
geometry.  ``csrc/block_kernels.cu`` evaluates the same function in its
epilogues, so the kernels' masks and ``keep_mask`` agree bit for bit.
Draw 0 is a half's first mask (the MLP's (S, 4C) mask, the attention
half's (S, C) mask), draw 1 the MLP half's second, (S, C) mask.  A
tensor-parallel shard of the MLP's hidden columns asks for the columns
``col0 .. col0 + cols - 1`` of the (S, 4C) mask, so that the shards drop
what the unsharded block drops.

uint32 arithmetic is carried in int64 tensors (torch has no uint32
multiply): values stay in [0, 2**32).
"""

from __future__ import annotations

from typing import Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # key increments (Weyl sequence)
_MASK32 = 0xFFFFFFFF


def check_rate(p: float) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")


def keep_threshold(p: float) -> int:
    """uint32 threshold T such that P(bits >= T) = 1 - p."""
    return min(int(round(p * 2.0 ** 32)), 2 ** 32 - 1)


def _mulhilo(m: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of m * b for a 32-bit constant m and b in
    [0, 2**32), without leaving int64: b is split into 16-bit halves."""
    t = m * (b >> 16)                      # < 2**48
    u = m * (b & 0xFFFF)                   # < 2**48
    low = ((t & 0xFFFF) << 16) + u         # < 2**49
    return (t >> 16) + (low >> 32), low & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    """``counter``: four int64 tensors (broadcastable) holding uint32 values,
    ``key``: two.  Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_bits(seeds: torch.Tensor, draw: int, rows: int, cols: int,
                col0: int = 0) -> torch.Tensor:
    """(B, rows, cols) int64 tensor of uint32 words of the columns ``col0`` ..
    ``col0 + cols - 1``; ``seeds``: (B,) int32."""
    dev = seeds.device
    key0 = (seeds.to(torch.int64) & _MASK32)[:, None, None]
    r = torch.arange(rows, device=dev, dtype=torch.int64)[None, :, None]
    c = torch.arange(col0, col0 + cols, device=dev, dtype=torch.int64)[None, None, :]
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    d = torch.full((), int(draw), device=dev, dtype=torch.int64)
    return philox4x32((c, r, d, zero), (key0, zero))[0].expand(
        seeds.shape[0], rows, cols)


def keep_mask(seeds: torch.Tensor, draw: int, rows: int, cols: int,
              p: float, col0: int = 0) -> torch.Tensor:
    """(B, rows, cols) bool keep mask of dropout rate ``p`` for draw ``draw``
    of the per-sample streams ``seeds`` (B,) int32, at the mask's columns
    ``col0`` .. ``col0 + cols - 1``."""
    check_rate(p)
    return random_bits(seeds, draw, rows, cols, col0) >= keep_threshold(p)
