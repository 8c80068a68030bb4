"""VFB²-SGD / -SVRG / -SAGA (paper Algorithms 2–7): the plain oracles and
the trainer.

The port of ``repro.core.algorithms`` (the linear, single-dominator,
non-pipelined part).  ``PartyLayout`` is a numpy-only copy, kept here so
the port imports nothing of the JAX package.

The epoch oracles are plain torch on the pooled (n, d) data: the
aggregation Σ_ℓ X_{G_ℓ} w_{G_ℓ} is block-separable, so ``x[ib] @ w`` is
what secure aggregation computes, and every gradient is formed the BUM
way, ϑ first, then Xᵀϑ + λ∇g(w).  They are dtype-generic (float64 on the
card is the reference ``chip_smoke.py`` holds the engine against) and
take an explicit ``(steps, batch)`` int64 index schedule ``idx``: they
never draw one.  The JAX package draws its schedule from threefry inside
the compiled epoch; the port cannot reproduce those bits, so
cross-checks hand both packages the same schedule, and ``train`` draws
each epoch's schedule with :func:`epoch_indices`.

``train(..., engine="fused")`` runs the epochs on ``core.engine``'s
``FusedEngine`` (the hot path: masked secure aggregation and the
vfl_grad kernel); ``engine="reference"`` runs the oracles here.  Both
take the same schedules, so they agree to float tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.losses import Problem
from repro_torch.core.secure_agg import seed_generator


@dataclasses.dataclass(frozen=True)
class PartyLayout:
    """Vertical partition of d features over q parties; m active parties.

    Parties 0..m-1 are active (hold labels); m..q-1 are passive.
    """

    q: int
    m: int
    bounds: Tuple[Tuple[int, int], ...]  # (lo, hi) per party

    @staticmethod
    def even(d: int, q: int, m: int) -> "PartyLayout":
        if not 1 <= m <= q:
            raise ValueError(f"need 1 <= m <= q, got m={m}, q={q}")
        cuts = np.linspace(0, d, q + 1).astype(int)
        return PartyLayout(q=q, m=m,
                           bounds=tuple((int(cuts[i]), int(cuts[i + 1]))
                                        for i in range(q)))

    def update_mask(self, d: int, active_only: bool) -> np.ndarray:
        """1.0 where the coordinate may be updated.

        ``active_only=True`` reproduces AFSVRG-VP: only active-party blocks
        (those whose owners hold labels) are trainable.
        """
        mask = np.zeros(d, np.float32)
        parties = range(self.m) if active_only else range(self.q)
        for p in parties:
            lo, hi = self.bounds[p]
            mask[lo:hi] = 1.0
        return mask

    def party_of_coord(self, d: int) -> np.ndarray:
        owner = np.zeros(d, np.int32)
        for p, (lo, hi) in enumerate(self.bounds):
            owner[lo:hi] = p
        return owner


def epoch_indices(seed: int, epoch: int, n: int, batch: int, steps: int,
                  device="cpu") -> torch.Tensor:
    """Epoch ``epoch``'s ``(steps, batch)`` int64 minibatch schedule, drawn
    uniformly from [0, n) by a CPU generator seeded from ``(seed, epoch)``
    (so it is the same on every device), then moved to ``device``."""
    gen = seed_generator(torch.Generator(), seed, epoch)
    return torch.randint(0, n, (steps, batch), generator=gen) \
        .to(torch.device(device))


def last_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """For each position i of ``ids`` (R,), the last position j with
    ``ids[j] == ids[i]``.  ``dst[ids] = values[last_occurrence(ids)]``
    is a scatter in which the last occurrence of a duplicate id wins on
    every device: all writers of one slot write the same value, so the
    order CUDA's ``index_put_`` picks does not matter.  O(R²), with no
    data-dependent shape, so it runs inside a CUDA graph."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    same = ids[:, None] == ids[None, :]
    return torch.where(same, pos, -1).amax(1)


def _grad_from_theta(problem: Problem, x, w, theta_vec):
    """BUM gradient: Xᵀϑ/b + λ∇g(w) (block-separable ⇒ full-vector form)."""
    return x.T @ theta_vec / theta_vec.shape[0] \
        + problem.lam * problem.reg_grad(w)


# ---------------------------------------------------------------------------
# epoch oracles (a Python loop over the schedule's rows)
# ---------------------------------------------------------------------------

def sgd_epoch(problem: Problem, w, x, y, lr, mask, idx):
    for ib in idx:
        xb, yb = x[ib], y[ib]
        theta = problem.theta(xb @ w, yb)   # dominator computes ϑ
        g = _grad_from_theta(problem, xb, w, theta)
        w = w - lr * mask * g
    return w


def svrg_epoch(problem: Problem, w, w_snap, mu, x, y, lr, mask, idx):
    """Inner loop of VFB²-SVRG (Alg. 4/5): v = g_i(w) − g_i(w̃) + ∇f(w̃)."""
    for ib in idx:
        xb, yb = x[ib], y[ib]
        th1 = problem.theta(xb @ w, yb)        # ϑ₁ at current iterate
        th0 = problem.theta(xb @ w_snap, yb)   # ϑ₀ at snapshot
        g1 = _grad_from_theta(problem, xb, w, th1)
        g0 = _grad_from_theta(problem, xb, w_snap, th0)
        w = w - lr * mask * (g1 - g0 + mu)
    return w


def full_gradient(problem: Problem, w, x, y):
    theta = problem.theta(x @ w, y)
    return x.T @ theta / x.shape[0] + problem.lam * problem.reg_grad(w)


def saga_init(problem: Problem, w, x, y):
    """Alg. 6 step 2: the ϑ̃ table at ``w`` and its average (1/n)Xᵀϑ̃."""
    theta_tab = problem.theta(x @ w, y)
    return theta_tab, x.T @ theta_tab / x.shape[0]


def saga_epoch(problem: Problem, w, theta_tab, avg, x, y, lr, mask, idx):
    """VFB²-SAGA (Alg. 6/7) with the linear-model memory trick.

    The history table stores per-sample ϑ̃_i (scalar) instead of the full
    α_i = ϑ̃_i·x_i vector; ``avg`` maintains (1/n)Σ_j ϑ̃_j x_j
    incrementally.  The λ∇g term is applied at the current iterate.  On
    duplicate indices in a minibatch the last write wins.  ``theta_tab``
    and ``avg`` are not modified; the updated copies are returned.
    """
    n = x.shape[0]
    theta_tab = theta_tab.clone()
    for ib in idx:
        xb, yb = x[ib], y[ib]
        th_new = problem.theta(xb @ w, yb)
        th_old = theta_tab[ib]
        v = (xb.T @ (th_new - th_old)) / ib.shape[0] + avg \
            + problem.lam * problem.reg_grad(w)
        w = w - lr * mask * v
        avg = avg + xb.T @ (th_new - th_old) / n
        theta_tab[ib] = th_new[last_occurrence(ib)]
    return w, theta_tab, avg


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    w: np.ndarray
    history: List[dict]  # per-epoch: objective, epoch, algo


def _eval(problem, w, x, y):
    return float(torch.mean(problem.loss(x @ w, y))
                 + problem.lam * torch.sum(problem.reg(w)))


_UNPORTED = (("multi_dominator", "A6"), ("pipelined", "A6"),
             ("deep", "A8"), ("checkpoint_dir", "A9"),
             ("resume_from", "A9"), ("supervise", "A10"))


def train(
    problem: Problem,
    x,
    y,
    layout: PartyLayout,
    algo: str = "svrg",
    epochs: int = 20,
    lr: float = 0.5,
    batch: int = 32,
    seed: int = 0,
    active_only: bool = False,  # True => AFSVRG-VP-style baseline
    w0=None,
    engine: str = "reference",  # "fused" => core.engine.FusedEngine epochs
    engine_config=None,         # core.engine.EngineConfig when engine="fused"
    multi_dominator: bool = False,
    pipelined: bool = False,
    deep: bool = False,
    checkpoint_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    supervise: bool = False,
    device="cuda",
) -> TrainResult:
    """Train a linear VFB² model for ``epochs`` epochs of ``algo`` in
    {"sgd", "svrg", "saga"} on ``device`` (default the card; raises
    without one, so the CPU runs only when asked for).

    ``x`` (n, d) and ``y`` (n,) are numpy arrays or tensors.  Epoch ``ep``
    runs the schedule ``epoch_indices(seed, ep, n, batch, n // batch)``
    on either engine, so ``engine="fused"`` and ``engine="reference"``
    agree to float tolerance.  The fused engine's masks are seeded from
    ``(seed, ep)``.  ``history`` holds each epoch's full objective.

    ``multi_dominator``, ``pipelined``, ``deep``, ``checkpoint_dir``,
    ``resume_from`` and ``supervise`` are not ported yet and raise
    ``NotImplementedError`` naming the ROADMAP queue-A item that ports
    them.
    """
    given = dict(multi_dominator=multi_dominator, pipelined=pipelined,
                 deep=deep, checkpoint_dir=checkpoint_dir,
                 resume_from=resume_from, supervise=supervise)
    for name, item in _UNPORTED:
        if given[name] not in (False, None):
            raise NotImplementedError(
                f"train({name}=...) is not ported yet (ROADMAP {item})")
    if algo not in ("sgd", "svrg", "saga"):
        raise ValueError(f"unknown algo {algo}")
    dev = resolve_device(device)
    n, d = x.shape
    steps = max(1, n // batch)
    if engine == "fused":
        return _train_fused(problem, x, y, layout, algo, epochs, lr, batch,
                            seed, active_only, w0, engine_config, dev)
    if engine != "reference":
        raise ValueError(f"unknown engine {engine}")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w = torch.zeros(d, dtype=torch.float32, device=dev) if w0 is None \
        else torch.as_tensor(w0, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(layout.update_mask(d, active_only), device=dev)
    if algo == "saga":
        theta_tab, avg = saga_init(problem, w, x, y)
    hist = []
    for ep in range(epochs):
        idx = epoch_indices(seed, ep, n, batch, steps, dev)
        if algo == "sgd":
            w = sgd_epoch(problem, w, x, y, lr, mask, idx)
        elif algo == "svrg":
            mu = full_gradient(problem, w, x, y)
            w = svrg_epoch(problem, w, w, mu, x, y, lr, mask, idx)
        else:
            w, theta_tab, avg = saga_epoch(problem, w, theta_tab, avg, x, y,
                                           lr, mask, idx)
        hist.append({"epoch": ep + 1, "objective": _eval(problem, w, x, y),
                     "algo": algo})
    return TrainResult(w=w.cpu().numpy(), history=hist)


def _train_fused(problem, x, y, layout, algo, epochs, lr, batch, seed,
                 active_only, w0, engine_config, dev) -> TrainResult:
    """Hot-path trainer: the engine's epochs, each a CUDA-graph replay of
    its step on the card with no host sync inside, and one objective
    evaluation (one sync) after each."""
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    n, d = x.shape
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, active_only=active_only,
                      device=dev)
    wq = eng.pack_w(np.zeros(d, np.float32) if w0 is None else w0)
    steps = max(1, n // batch)
    if algo == "saga":
        tabq, avgq = eng.saga_init(wq, (seed,))
    hist = []
    for ep in range(epochs):
        idx = epoch_indices(seed, ep, n, batch, steps, dev)
        key = (seed, ep)
        if algo == "sgd":
            wq = eng.sgd_epoch(wq, lr, idx, key)
        elif algo == "svrg":
            muq = eng.full_gradient(wq, key)
            wq = eng.svrg_epoch(wq, wq, muq, lr, idx, key)
        else:
            wq, tabq, avgq = eng.saga_epoch(wq, tabq, avgq, lr, idx, key)
        hist.append({"epoch": ep + 1, "objective": eng.objective(wq),
                     "algo": algo, "engine": "fused"})
    return TrainResult(w=eng.unpack_w(wq), history=hist)


def accuracy(w, x, y) -> float:
    pred = np.sign(np.asarray(x) @ np.asarray(w))
    pred[pred == 0] = 1
    return float((pred == np.asarray(y)).mean())


def rmse(w, x, y) -> float:
    err = np.asarray(x) @ np.asarray(w) - np.asarray(y)
    return float(np.sqrt(np.mean(err ** 2)))
