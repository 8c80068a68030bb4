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
