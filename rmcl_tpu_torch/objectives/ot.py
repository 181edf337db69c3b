"""IPOT optimal transport for the ITM word-patch-alignment loss (port of
``rmcl_tpu/objectives/ot.py``).

Behavioural spec: reference vilt/modules/objectives.py:24-95
(cost_matrix_cosine / ipot / optimal_transport_dist), the JAX package's
formulation kept as it is: fifty proximal-point rounds of reciprocals with
1e4 added on the padded rows and columns, not a log-domain Sinkhorn.  Every
function computes in fp32 whatever type it is given (the reference runs this
under ``autocast(enabled=False)``); the plan is built without a graph, so a
distance's gradient flows through the cost only.

On the card each IPOT round is ``LAUNCHES_PER_ROUND`` small elementwise and
``bmm`` launches of PyTorch's own (``ipot_calls`` counts the calls that ran on
a CUDA tensor); the solver is plain PyTorch as the JAX package's is plain
JAX outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

# Q = A T; Q sigma; x y_len; + y_mask; 1 / . (a reciprocal and a scalar product);
# delta Q; x x_len; + x_mask; 1 / . (two); delta Q; . sigma
LAUNCHES_PER_ROUND = 13
ipot_calls: Dict[str, int] = {"calls": 0, "rounds": 0}


def reset_ipot_calls() -> None:
    for k in ipot_calls:
        ipot_calls[k] = 0


def cost_matrix_cosine(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pairwise cosine distance in fp32: (B, Lx, D), (B, Ly, D) -> (B, Lx, Ly)."""
    x32, y32 = x.float(), y.float()
    xn = x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True).clamp(min=eps)
    yn = y32 / torch.linalg.vector_norm(y32, dim=-1, keepdim=True).clamp(min=eps)
    return 1.0 - torch.bmm(xn, yn.transpose(1, 2))


@torch.no_grad()
def ipot(C: torch.Tensor, x_len: torch.Tensor, x_pad: torch.Tensor, y_len: torch.Tensor,
         y_pad: torch.Tensor, joint_pad: torch.Tensor, beta: float, iteration: int,
         k: int) -> torch.Tensor:
    """Inexact proximal-point OT plan.  C (B, M, N); x_len (B,); x_pad (B, M)
    bool; y_len (B,); y_pad (B, N) bool; joint_pad (B, M, N) bool.  Returns
    the plan T (B, N, M), zero on ``joint_pad``, without a graph."""
    C = C.float()
    b, m, n = C.shape
    if C.is_cuda:
        ipot_calls["calls"] += 1
        ipot_calls["rounds"] += iteration
    jp_t = joint_pad.transpose(1, 2)                            # (B, N, M)
    sigma = torch.where(x_pad, 0.0, 1.0 / x_len.float()[:, None])  # (B, M)
    T = torch.where(jp_t, 0.0, torch.ones(b, n, m, device=C.device))
    A = torch.where(jp_t, 0.0, torch.exp(-C.transpose(1, 2) / beta))
    x_len_b = x_len.float()[:, None, None]
    y_len_b = y_len.float()[:, None, None]
    x_mask = (x_pad.float() * 1e4)[:, None, :]                  # (B, 1, M)
    y_mask = (y_pad.float() * 1e4)[:, None, :]                  # (B, 1, N)

    def delta_of(Q, sc):
        return 1.0 / (y_len_b * torch.bmm(Q, sc).reshape(b, 1, n) + y_mask)

    for _ in range(iteration):
        Q = A * T                                               # (B, N, M)
        sc = sigma.reshape(b, m, 1)
        for _ in range(k - 1):
            sc = (1.0 / (x_len_b * torch.bmm(delta_of(Q, sc), Q) + x_mask)).reshape(b, m, 1)
        delta = delta_of(Q, sc)
        sigma_row = 1.0 / (x_len_b * torch.bmm(delta, Q) + x_mask)   # (B, 1, M)
        T = delta.reshape(b, n, 1) * Q * sigma_row
        sigma = sigma_row.reshape(b, m)
    return torch.where(jp_t, 0.0, T)


def trace_bmm(cost: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """trace(cost @ T) per sample: cost (B, M, N), T (B, N, M) -> (B,)."""
    return (cost * T.transpose(1, 2)).sum((1, 2))


def optimal_transport_dist(txt_emb: torch.Tensor, img_emb: torch.Tensor,
                           txt_pad: torch.Tensor, img_pad: torch.Tensor,
                           beta: float = 0.5, iteration: int = 50, k: int = 1) -> torch.Tensor:
    """OT distance between padded token sets (reference objectives.py:79-95)."""
    cost = cost_matrix_cosine(txt_emb, img_emb)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, 0.0, cost)
    txt_len = (txt_pad.shape[1] - txt_pad.sum(1)).float()
    img_len = (img_pad.shape[1] - img_pad.sum(1)).float()
    T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad, joint_pad, beta, iteration, k)
    return trace_bmm(cost, T)
