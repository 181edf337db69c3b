"""Shared static-shape bucket geometry (the port's own copy of the JAX
package's ``core/buckets.py``).

The /8 text-length bucket is shared by the callers that must stay in
lockstep: the greedy attack's internal forwards
(``attacks/greedy_fused.py:_text_bucket``) here, and in the JAX package also
the train path and retrieval ranking.  Changing the rounding in one copy but
not the other would make the two packages run the attack at other lengths.
"""

from __future__ import annotations

TEXT_BUCKET_ALIGN = 8


def text_bucket(n_valid: int, max_len: int,
                align: int = TEXT_BUCKET_ALIGN) -> int:
    """Smallest align-multiple static text length covering ``n_valid``
    tokens, floored at ``align`` and capped at ``max_len``."""
    return min(max_len, max(-(-n_valid // align) * align, align))


def bucket_enabled(cfg, which: str) -> bool:
    """Resolve the per-consumer text-bucket flag (``which`` in
    {"attack", "eval", "train"}): the ``<which>_text_bucket`` config
    field when set, else the deprecated ``greedy_text_bucket`` umbrella
    alias (the single pre-round-5 flag)."""
    v = getattr(cfg, f"{which}_text_bucket", None)
    if v is None:
        v = getattr(cfg, "greedy_text_bucket", True)
    return bool(v)
