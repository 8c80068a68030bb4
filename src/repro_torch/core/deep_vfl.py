"""Deep (nonlinear) VFB²: party-local encoders + secure fused head, and
the sequential training oracle.

The port of ``repro.core.deep_vfl``.  Each party ℓ encodes its block
with a private two-layer encoder h_ℓ = tanh(x_ℓ W1_ℓ + b1_ℓ) W2_ℓ; the
representations are aggregated through Algorithm 1 and the active
parties' head maps the sum to a logit.

The oracle (:func:`train_deep_vfl`) is a Python loop over the rows of an
explicit schedule.  Its gradients are formed the protocol way: ϑ_logit
at the dominator, ϑ_z = ϑ_logit·head broadcast to every party, then each
party's own Jacobian transpose, written out for the tanh layer (no
autodiff across parties).  Every leaf carries λ∇g(·), mdom·λ∇g(·) in the
multi-dominator round.  It works in the dtype of its data (float64 on the
card is the yardstick ``chip_smoke.py`` holds the engine against).
``_bum_dom_grads`` keeps the m dominators' gradients apart for the
bounded-delay oracles of ``core.staleness``.
:func:`train_centralized` trains the same model through one autograd
graph: the losslessness oracle.  The fused engine's ``deep_*_epoch``
methods (``core.engine``) are the hot path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import (PartyLayout, _restore, _rounds,
                                         _save, epoch_indices)
from repro_torch.core.losses import Problem
from repro_torch.core.secure_agg import seed_generator


@dataclasses.dataclass
class DeepVFLParams:
    enc_w1: List[torch.Tensor]   # per party: (d_ℓ, hidden)
    enc_b1: List[torch.Tensor]   # per party: (hidden,)
    enc_w2: List[torch.Tensor]   # per party: (hidden, d_rep)
    head: torch.Tensor           # (d_rep,) — active parties' model


def init_deep_vfl(gen: torch.Generator, layout: PartyLayout, d: int,
                  hidden: int = 32, d_rep: int = 16) -> DeepVFLParams:
    """Random encoders with the reference's scales (W1 ~ 2/√d_ℓ·N(0, 1),
    W2 ~ N(0, 1)/√hidden, b1 = 0, head ~ N(0, 1)/√d_rep), drawn from
    ``gen`` on the generator's device.  ``d`` is the feature width the
    layout splits (kept for the reference's signature)."""
    if layout.bounds[-1][1] != d:
        raise ValueError(f"layout covers {layout.bounds[-1][1]} features, "
                         f"d={d}")
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    enc_w1, enc_b1, enc_w2 = [], [], []
    for lo, hi in layout.bounds:
        d_p = hi - lo
        enc_w1.append(normal(d_p, hidden) * (2.0 / np.sqrt(d_p)))
        enc_b1.append(torch.zeros((hidden,), device=dev))
        enc_w2.append(normal(hidden, d_rep) / np.sqrt(hidden))
    head = normal(d_rep) / np.sqrt(d_rep)
    return DeepVFLParams(enc_w1, enc_b1, enc_w2, head)


def _party_encode(w1, b1, w2, x_block):
    h = torch.tanh(x_block @ w1 + b1)
    return h @ w2                                     # (B, d_rep)


def fused_forward(params: DeepVFLParams, x_blocks,
                  gen: Optional[torch.Generator] = None,
                  mask_scale: float = 1.0):
    """Securely aggregated representation z = Σ_ℓ h_ℓ and logit.

    With ``gen`` given, executes the masked aggregation numerically (masks
    drawn per party; cancellation is exact to fp) — the secure and plain
    paths agree to float tolerance.
    """
    parts = [_party_encode(w1, b1, w2, xb) for w1, b1, w2, xb in
             zip(params.enc_w1, params.enc_b1, params.enc_w2, x_blocks)]
    if gen is not None:
        deltas = [mask_scale * torch.randn(p.shape, generator=gen,
                                           device=p.device,
                                           dtype=torch.float32)
                  for p in parts]
        xi1 = sum(p + d for p, d in zip(parts, deltas))
        xi2 = sum(deltas)
        z = xi1 - xi2
    else:
        z = sum(parts)
    logit = z @ params.head
    return z, logit


def initial_params(seed: int, layout: PartyLayout, d: int, hidden: int = 32,
                   d_rep: int = 16) -> DeepVFLParams:
    """The trainers' default start: :func:`init_deep_vfl` drawn on the CPU
    from a generator seeded from ``seed``, so it is the same on every
    device."""
    return init_deep_vfl(seed_generator(torch.Generator(), seed), layout, d,
                         hidden, d_rep)


# ---------------------------------------------------------------------------
# protocol-way gradients (shared by the SGD / SVRG oracles)
# ---------------------------------------------------------------------------
#
# ``pt`` is the parameter tuple (w1s, b1s, w2s, head): per-party tuples of
# the three encoder leaves and the head; a gradient has the same shape.

def _deep_fwd_acts(pt, xb, q: int):
    """Per-party activations and the aggregate at ``pt`` on the blocks
    ``xb``: (hs, a tuple of (B, hidden); z (B, d_rep)), the quantities the
    pipelined schedule carries one round stale."""
    w1, b1, w2, _ = pt
    hs = tuple(torch.tanh(xb[p] @ w1[p] + b1[p]) for p in range(q))
    z = sum(hs[p] @ w2[p] for p in range(q))
    return hs, z


def _bum_stale_grads(pt, xb, hs, z, yb, problem: Problem, q: int,
                     mdom: int = 1):
    """BUM gradients of one round: ϑ and the regularisers at ``pt``, each
    party's Jacobian at the activations ``(hs, z)`` (fresh in a fresh
    round, one update old in a pipelined one).

    ``mdom > 1`` is the multi-dominator round: the blocks carry the m
    dominators' concatenated minibatches, each dominator's ϑ is normalised
    by its own batch, the λ∇g term enters once per concurrent update
    (mdom·λ∇g), and the full-row contractions sum the m updates."""
    enc_w1, enc_b1, enc_w2, head = pt
    lam = problem.lam
    theta_logit = problem.theta(z @ head, yb) / (yb.shape[0] // mdom)
    theta_z = theta_logit[:, None] * head              # ∂L/∂z, broadcast
    g_head = z.T @ theta_logit + mdom * lam * problem.reg_grad(head)
    gw1, gb1, gw2 = [], [], []
    for p in range(q):
        du = (theta_z @ enc_w2[p].T) * (1.0 - hs[p] * hs[p])   # tanh'
        gw1.append(xb[p].T @ du + mdom * lam * problem.reg_grad(enc_w1[p]))
        gb1.append(du.sum(0) + mdom * lam * problem.reg_grad(enc_b1[p]))
        gw2.append(hs[p].T @ theta_z
                   + mdom * lam * problem.reg_grad(enc_w2[p]))
    return tuple(gw1), tuple(gb1), tuple(gw2), g_head


def _bum_dom_grads(pt, xb, hs, z, yb, problem: Problem, q: int, m: int):
    """Per-dominator BUM gradients from the activations ``(hs, z)``: the
    m dominators' updates stay apart so that each stream can age under
    its own delay (the bounded-delay multi-dominator round;
    ``core.staleness`` drives it).  Returns per-party tuples of (m, ...)
    stacked encoder gradients, each carrying λ∇g once, and the fresh
    summed head gradient with m·λ∇g."""
    enc_w1, enc_b1, enc_w2, head = pt
    lam = problem.lam
    b = yb.shape[0] // m
    theta_logit = problem.theta(z @ head, yb) / b
    theta_z = theta_logit[:, None] * head
    g_head = z.T @ theta_logit + m * lam * problem.reg_grad(head)
    thz = theta_z.reshape(m, b, -1)
    gw1, gb1, gw2 = [], [], []
    for p in range(q):
        du = (theta_z @ enc_w2[p].T) * (1.0 - hs[p] * hs[p])
        dus = du.reshape(m, b, -1)
        gw1.append(xb[p].reshape(m, b, -1).transpose(1, 2) @ dus
                   + lam * problem.reg_grad(enc_w1[p])[None])
        gb1.append(dus.sum(1) + lam * problem.reg_grad(enc_b1[p])[None])
        gw2.append(hs[p].reshape(m, b, -1).transpose(1, 2) @ thz
                   + lam * problem.reg_grad(enc_w2[p])[None])
    return tuple(gw1), tuple(gb1), tuple(gw2), g_head


def _bum_grads(pt, xb, yb, problem: Problem, q: int, mdom: int = 1):
    """One fresh BUM round at ``pt`` on the blocks ``xb`` (a list of
    (B, d_ℓ)): the Jacobians at ``pt``'s own activations."""
    hs, z = _deep_fwd_acts(pt, xb, q)
    return _bum_stale_grads(pt, xb, hs, z, yb, problem, q, mdom)


def _apply_update(pt, g, lr, freeze: bool, m: int, q: int):
    """w ← w − lr·g with the passive parties (p ≥ m) frozen under
    ``freeze``; the head (the active parties' model) always trains."""
    w1, b1, w2, head = pt
    gw1, gb1, gw2, gh = g
    live = [0.0 if (freeze and p >= m) else 1.0 for p in range(q)]
    return (tuple(w1[p] - lr * live[p] * gw1[p] for p in range(q)),
            tuple(b1[p] - lr * live[p] * gb1[p] for p in range(q)),
            tuple(w2[p] - lr * live[p] * gw2[p] for p in range(q)),
            head - lr * gh)


def _combine(g1, g0, mu, mdom: int):
    """SVRG's v = g₁ − g₀ + mdom·μ on every leaf."""
    def leaf(a, b, c):
        return a - b + mdom * c
    return tuple(tuple(leaf(a, b, c) for a, b, c in zip(*t))
                 if isinstance(t[0], tuple) else leaf(*t)
                 for t in zip(g1, g0, mu))


# The rounds of :func:`algorithms._rounds`: ``read(pt, ib)`` is the forward
# read of the round's rows (at the current params, or in a pipelined
# epoch at the params before the previous round's update) and
# ``step(pt, acts, ib)`` the update from it.

def _sgd_round(problem, blocks, y, lr, freeze, m, q, mdom):
    def step(pt, acts, ib):
        hs, z = acts
        g = _bum_stale_grads(pt, [b[ib] for b in blocks], hs, z, y[ib],
                             problem, q, mdom)
        return _apply_update(pt, g, lr, freeze, m, q)
    return step


def _svrg_round(problem, snap, mu, blocks, y, lr, freeze, m, q, mdom):
    """v = g_i(w) − g_i(w̃) + mdom·μ per leaf (Alg. 4/5, deep form).  Both
    sides' activations ride the read; the snapshot is constant, so its
    stale read equals the fresh one."""
    def step(pt, acts, ib):
        xb, yb = [b[ib] for b in blocks], y[ib]
        (hs, z), (hss, zs) = acts
        g1 = _bum_stale_grads(pt, xb, hs, z, yb, problem, q, mdom)
        g0 = _bum_stale_grads(snap, xb, hss, zs, yb, problem, q, mdom)
        return _apply_update(pt, _combine(g1, g0, mu, mdom), lr, freeze, m,
                             q)
    return step


def _objective(problem: Problem, params: DeepVFLParams, blocks, y) -> float:
    """Full objective: the data loss + λ·Σ g(·) over every parameter (head
    and encoders)."""
    _, logits = fused_forward(params, blocks)
    regv = sum(torch.sum(problem.reg(a)) for a in
               (*params.enc_w1, *params.enc_b1, *params.enc_w2, params.head))
    return float(torch.mean(problem.loss(logits, y)) + problem.lam * regv)


def _to_params(pt) -> DeepVFLParams:
    return DeepVFLParams(list(pt[0]), list(pt[1]), list(pt[2]), pt[3])


def _to_tuple(params: DeepVFLParams, device, dtype):
    def cast(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    return (tuple(map(cast, params.enc_w1)), tuple(map(cast, params.enc_b1)),
            tuple(map(cast, params.enc_w2)), cast(params.head))


def _setup(x, y, layout, params, seed, hidden, d_rep, device):
    """Data as per-party blocks on ``device`` in x's floating dtype (float32
    for anything else) and the start as a parameter tuple."""
    dev = resolve_device(device)
    xt = torch.as_tensor(x, device=dev)
    if not xt.is_floating_point():
        xt = xt.float()
    yt = torch.as_tensor(y, device=dev).to(xt.dtype)
    if params is None:
        params = initial_params(seed, layout, xt.shape[1], hidden, d_rep)
    blocks = tuple(xt[:, lo:hi] for lo, hi in layout.bounds)
    return dev, blocks, yt, _to_tuple(params, dev, xt.dtype)


def _schedules(indices, seed, epochs, n, rows, steps, dev):
    """Each epoch's (steps, rows) schedule: ``indices[ep]`` where given,
    else :func:`epoch_indices`."""
    if indices is None:
        return [epoch_indices(seed, ep, n, rows, steps, dev)
                for ep in range(epochs)]
    if len(indices) != epochs:
        raise ValueError(f"indices holds {len(indices)} schedules for "
                         f"{epochs} epochs")
    out = [torch.as_tensor(ix).to(device=dev, dtype=torch.int64)
           for ix in indices]
    for ix in out:
        if ix.dim() != 2 or ix.shape[1] != rows:
            raise ValueError(f"each schedule must be (steps, {rows}); got "
                             f"{tuple(ix.shape)}")
    return out


def train_deep_vfl(problem: Problem, x, y, layout: PartyLayout,
                   epochs: int = 20, lr: float = 0.05, batch: int = 32,
                   seed: int = 0, hidden: int = 32, d_rep: int = 16,
                   freeze_passive: bool = False,
                   params: Optional[DeepVFLParams] = None,
                   algo: str = "sgd", multi_dominator: bool = False,
                   pipelined: bool = False,
                   indices: Optional[Sequence] = None,
                   checkpoint_dir: Optional[str] = None,
                   resume_from: Optional[str] = None,
                   keep_last: Optional[int] = 1,
                   horizon_epochs: Optional[int] = None, device="cuda"):
    """BUM training of the deep VFL model (the sequential oracle) on
    ``device`` (default the card; raises without one).  Returns
    ``(params, objectives)``: the final ``DeepVFLParams`` and each
    epoch's full objective.

    ``algo="svrg"`` runs the variance-reduced inner loop (a snapshot and
    its full gradient each epoch, Alg. 4/5).  ``multi_dominator=True``
    runs all m = layout.m active parties as concurrent dominators per
    round (m·batch rows a step, every party applying the m summed
    updates); ``pipelined=True`` runs the τ = 1 schedule (round t's
    update from activations computed at the params one update old).  The
    flags compose.  ``freeze_passive=True`` freezes the passive encoders.

    ``x`` and ``y`` are numpy arrays or tensors; the oracle runs in x's
    floating dtype.  ``params`` is the start (default
    :func:`initial_params` of ``seed``).  ``indices`` gives one
    ``(steps, rows)`` int64 schedule per epoch (rows = m·batch for the
    multi-dominator round); by default epoch ``ep`` runs
    ``epoch_indices(seed, ep, n, rows, n // batch)``, as ``train`` does.

    ``checkpoint_dir=`` atomically checkpoints the parameters and the
    objectives so far (NaN-filled to ``horizon_epochs``) after every
    epoch, keeping the newest ``keep_last``; ``resume_from=`` restores
    them and continues from the epoch after the bundle's, bit for bit the
    uninterrupted run."""
    if algo not in ("sgd", "svrg"):
        raise ValueError(f"unknown deep algo {algo!r}")
    dev, blocks, yt, pt = _setup(x, y, layout, params, seed, hidden, d_rep,
                                 device)
    n = yt.shape[0]
    q, m = layout.q, layout.m
    mm = m if multi_dominator else 1
    steps = max(1, n // batch)
    kw = dict(lr=lr, freeze=freeze_passive, m=m, q=q, mdom=mm)
    objs = np.full(max(horizon_epochs or 0, epochs), np.nan)
    st, ep0 = _restore(resume_from, {"pt": pt, "objs": objs})
    pt = tuple(tuple(torch.as_tensor(a, device=dev) for a in leaf)
               for leaf in st["pt"][:3]) \
        + (torch.as_tensor(st["pt"][3], device=dev),)
    objs = st["objs"]
    hist = [float(o) for o in objs[:ep0]]
    schedules = _schedules(indices, seed, epochs, n, mm * batch, steps, dev)
    for ep in range(ep0, epochs):
        idx = schedules[ep]

        def read(p, ib):
            return _deep_fwd_acts(p, [b[ib] for b in blocks], q)

        if algo == "svrg":
            snap = pt
            mu = _bum_grads(snap, list(blocks), yt, problem, q)
            step = _svrg_round(problem, snap, mu, blocks, yt, **kw)
            pt = _rounds(step, pt, lambda p, ib: (read(p, ib),
                                                  read(snap, ib)),
                         idx, pipelined)
        else:
            pt = _rounds(_sgd_round(problem, blocks, yt, **kw), pt, read,
                         idx, pipelined)
        hist.append(_objective(problem, _to_params(pt), blocks, yt))
        objs[ep] = hist[-1]
        _save(checkpoint_dir, {"pt": pt, "objs": objs}, ep + 1, keep_last)
    return _to_params(pt), hist


def train_centralized(problem: Problem, x, y, layout: PartyLayout,
                      epochs: int = 20, lr: float = 0.05, batch: int = 32,
                      seed: int = 0, hidden: int = 32, d_rep: int = 16,
                      params: Optional[DeepVFLParams] = None,
                      indices: Optional[Sequence] = None, device="cuda"):
    """The same architecture trained through ONE autograd graph (no
    protocol): the losslessness oracle, equal to :func:`train_deep_vfl`
    from the same start on the same schedules.  The objective carries
    λ·g(·) over every parameter, as the BUM path does.  ``params`` and
    ``indices`` as in :func:`train_deep_vfl`.  Returns ``(params,
    objectives)``."""
    dev, blocks, yt, pt = _setup(x, y, layout, params, seed, hidden, d_rep,
                                 device)
    n = yt.shape[0]
    leaves = [*pt[0], *pt[1], *pt[2], pt[3]]
    q = layout.q
    hist = []
    for idx in _schedules(indices, seed, epochs, n, batch,
                          max(1, n // batch), dev):
        for ib in idx:
            leaves = [a.detach().requires_grad_() for a in leaves]
            w1, b1, w2 = leaves[:q], leaves[q:2 * q], leaves[2 * q:3 * q]
            z = sum(torch.tanh(blocks[p][ib] @ w1[p] + b1[p]) @ w2[p]
                    for p in range(q))
            regv = sum(torch.sum(problem.reg(a)) for a in leaves)
            loss = torch.mean(problem.loss(z @ leaves[-1], yt[ib])) \
                + problem.lam * regv
            grads = torch.autograd.grad(loss, leaves)
            leaves = [a.detach() - lr * g for a, g in zip(leaves, grads)]
        pt = (tuple(leaves[:q]), tuple(leaves[q:2 * q]),
              tuple(leaves[2 * q:3 * q]), leaves[-1])
        hist.append(_objective(problem, _to_params(pt), blocks, yt))
    return _to_params(pt), hist
