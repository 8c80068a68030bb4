"""The paper's four objectives (Problems 13, 14, 17, 18) on torch tensors.

The port of ``repro.core.losses``.  Each problem exposes:
  * ``loss(agg, y)``        — per-sample data loss given agg = wᵀx
  * ``theta(agg, y)``       — ϑ = ∂loss/∂agg (the BUM payload)
  * ``reg(w_block)``        — per-block regularizer g(w_{G_ℓ}) value
  * ``reg_grad(w_block)``   — ∇g(w_{G_ℓ})
  * ``lam``                 — regularization coefficient λ
All are elementwise torch and block-separable, as required by problem (P).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    loss: Callable
    theta: Callable
    reg: Callable
    reg_grad: Callable
    lam: float
    strongly_convex: bool

    def objective(self, w_blocks, x_blocks, y):
        """Full objective f(w) for vertically partitioned data (host eval)."""
        agg = sum(x @ w for w, x in zip(w_blocks, x_blocks))
        data = torch.mean(self.loss(agg, y))
        regv = sum(torch.sum(self.reg(w)) for w in w_blocks)
        return data + self.lam * regv

    def block_grad(self, w_block, x_block, theta_vec, n):
        """Party-local gradient from received ϑ (paper Alg. 3 step 3)."""
        return x_block.T @ theta_vec / n + self.lam * self.reg_grad(w_block)


def _softplus0(u):
    # log(1 + e^u) = logaddexp(0, u), the form the reference uses
    return torch.logaddexp(torch.zeros_like(u), u)


def _l2_reg(w):
    return 0.5 * w * w


def _l2_reg_grad(w):
    return w


def _nc_reg(w):
    # nonconvex regularizer  Σ w²/(1+w²)/2  (problem 14 uses λ/2 Σ w²/(1+w²))
    return 0.5 * w * w / (1.0 + w * w)


def _nc_reg_grad(w):
    return w / (1.0 + w * w) ** 2


def _logistic_loss(agg, y):
    return _softplus0(-y * agg)


def _logistic_theta(agg, y):
    return -y * torch.sigmoid(-y * agg)


def logistic_l2(lam: float = 1e-4) -> Problem:
    """Problem (13): ℓ2-regularized logistic regression (μ-strongly convex)."""
    return Problem("logistic_l2", _logistic_loss, _logistic_theta, _l2_reg,
                   _l2_reg_grad, lam, True)


def logistic_nonconvex(lam: float = 1e-4) -> Problem:
    """Problem (14): logistic loss + nonconvex sigmoid-type regularizer."""
    return Problem("logistic_nonconvex", _logistic_loss, _logistic_theta,
                   _nc_reg, _nc_reg_grad, lam, False)


def ridge(lam: float = 1e-4) -> Problem:
    """Problem (17): ℓ2-regularized least squares (per-sample (wᵀx−y)²)."""
    def loss(agg, y):
        return (agg - y) ** 2

    def theta(agg, y):
        return 2.0 * (agg - y)

    return Problem("ridge", loss, theta, _l2_reg, _l2_reg_grad, lam, True)


def robust_regression(lam: float = 0.0) -> Problem:
    """Problem (18): nonconvex robust regression, L(u)=log(u²/2+1), u=y−wᵀx."""
    def loss(agg, y):
        u = y - agg
        return torch.log(u * u / 2.0 + 1.0)

    def theta(agg, y):
        u = y - agg
        return -u / (u * u / 2.0 + 1.0)

    return Problem("robust_regression", loss, theta, torch.zeros_like,
                   torch.zeros_like, lam, False)


PROBLEMS = {
    "logistic_l2": logistic_l2,
    "logistic_nonconvex": logistic_nonconvex,
    "ridge": ridge,
    "robust_regression": robust_regression,
}
