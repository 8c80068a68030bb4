"""Plain PyTorch versions of the kernels (allclose targets).

The CPU path of every wrapper in ``ops`` and the yardstick the card's
kernels are held against.  On the card the main path never calls these.
"""
from __future__ import annotations

import torch


def vfl_forward_ref(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z = xb @ w in f32, with the shapes ``ops.vfl_grad`` takes:
    xb (B, D) with w (D,) or (D, M), or xb (P, B, D) with w (P, D) or
    (P, D, M); a rank-1 weight gives a rank-1 (per party) z."""
    x = xb.float()
    wf = w.float()
    if xb.dim() == 3 and w.dim() == 2:
        return torch.matmul(x, wf.unsqueeze(-1)).squeeze(-1)
    return torch.matmul(x, wf)


def vfl_backward_ref(xb: torch.Tensor, theta: torch.Tensor, w=None,
                     lam: float = 0.0, denom=None) -> torch.Tensor:
    """g = xbᵀθ/denom (+ λw) in f32, with the shapes ``ops.vfl_grad``
    takes in backward mode: xb (B, D) with θ (B,) or (B, M), or xb
    (P, B, D) with θ (P, B) or (P, B, M) (an ``expand`` view for a shared
    θ); w None or shaped as g.  ``denom`` defaults to B."""
    denom = xb.shape[-2] if denom is None else denom
    rank1 = theta.dim() == xb.dim() - 1
    th = theta.float().unsqueeze(-1) if rank1 else theta.float()
    g = torch.matmul(xb.float().transpose(-1, -2), th) / denom
    if w is not None:
        g = g + lam * (w.float().unsqueeze(-1) if rank1 else w.float())
    return g.squeeze(-1) if rank1 else g


def vfl_grad_ref(xb, w, theta, lam: float, denom=None):
    """Fused VFL forward partial + BUM backward (the paper's hot loop).

    Rank-k oracle: xb (B, D); w (D,) or (D, M); theta (B,) or (B, M).
    Returns (z = xb @ w, g = xbᵀθ/denom + λw) with the same rank as the
    inputs; ``denom`` defaults to B."""
    denom = xb.shape[0] if denom is None else denom
    x = xb.float()
    z = x @ w.float()
    g = x.T @ theta.float() / denom + lam * w.float()
    return z, g
