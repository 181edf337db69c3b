"""MoCo contrastive objective (port of ``rmcl_tpu/objectives/contrastive.py``:
``infonce``; the momentum update and the queue come with the training step)."""

from __future__ import annotations

import torch

from rmcl_tpu_torch.objectives.losses import cross_entropy


def infonce(q: torch.Tensor, k: torch.Tensor, neg_queue: torch.Tensor,
            temperature: float):
    """logits = [q.k | q.queue] / tau in fp32, labels = 0 (reference
    objectives.py:271-274).  q, k: (N, 128); neg_queue: (128, K).
    Returns (loss, logits)."""
    q32 = q.float()
    l_pos = (q32 * k.float()).sum(-1, keepdim=True)
    l_neg = q32 @ neg_queue.float()
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    return cross_entropy(logits, labels), logits
