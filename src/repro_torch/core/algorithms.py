"""VFB²-SGD / -SVRG / -SAGA (paper Algorithms 2–7): the plain oracles and
the trainer.

The port of ``repro.core.algorithms``: the linear epochs (single-
dominator, multi-dominator and pipelined) and the trainer, which also
routes ``deep=True`` to ``core.deep_vfl`` and the engine's deep epochs.
``PartyLayout`` is a numpy-only copy, kept here so the port imports
nothing of the JAX package.

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
# multi-dominator and pipelined oracles
# ---------------------------------------------------------------------------
#
# Multi-dominator: every active party is a dominator.  In each round the m
# dominators draw their own minibatches (one (m·B) row of the schedule,
# dominator j's rows at [j·B, (j+1)·B)), compute their ϑ_j from the same
# read of the iterate, and every party applies all m BUM updates:
#
#     w_{t+1} = w_t − η Σ_{j<m} [ X_{b_j}ᵀ ϑ_j / B + λ∇g(w_t) ],
#
# so the regulariser enters m times.  Pipelined (the τ = 1 bounded-delay
# schedule of Theorems 1–6): round t's ϑ comes from the forward read of
# its rows taken at w_{t−1}, before round t−1's update, which is what the
# engine's split-batch step computes beside round t−1's backward; the
# first round's read is fresh.  The single-dominator pipelined epochs are
# the m = 1 case.

def _rounds(step, state, read, idx, pipelined: bool):
    """Run ``state = step(state, z, ib)`` over the schedule's rows, where
    ``z = read(state, ib)`` is the forward read of the round's rows: at
    the current state, or (``pipelined``) at the state before the
    previous round's update."""
    z = read(state, idx[0]) if pipelined else None
    for t in range(idx.shape[0]):
        ib = idx[t]
        z_next = read(state, idx[t + 1]) \
            if pipelined and t + 1 < idx.shape[0] else None
        state = step(state, z if pipelined else read(state, ib), ib)
        z = z_next
    return state


def _dom_sum(xb, theta, m: int, denom):
    """Σ_j X_{b_j}ᵀϑ_j / denom over the m dominators' row blocks of the
    concatenated (m·B) block, each dominator's term formed first."""
    b = xb.shape[0] // m
    return (xb.view(m, b, -1).transpose(1, 2) @ theta.view(m, b, 1)) \
        .squeeze(-1).div(denom).sum(0)


def _sgd_round(problem, x, y, lr, mask, m):
    def step(w, z, ib):
        theta = problem.theta(z, y[ib])
        g = _dom_sum(x[ib], theta, m, ib.shape[0] // m) \
            + m * problem.lam * problem.reg_grad(w)
        return w - lr * mask * g
    return step


def _svrg_round(problem, w_snap, mu, x, y, lr, mask, m):
    def step(w, z, ib):
        th1 = problem.theta(z, y[ib])            # on the (stale) read
        th0 = problem.theta(x[ib] @ w_snap, y[ib])   # snapshot: fresh
        b = ib.shape[0] // m
        v = x[ib].T @ th1 / b - x[ib].T @ th0 / b + m * (
            problem.lam * (problem.reg_grad(w) - problem.reg_grad(w_snap))
            + mu)
        return w - lr * mask * v
    return step


def _saga_round(problem, x, y, lr, mask, m):
    n = x.shape[0]

    def step(state, z, ib):
        w, tab, avg = state
        th_new = problem.theta(z, y[ib])
        raw = _dom_sum(x[ib], th_new - tab[ib], m, 1)
        v = raw / (ib.shape[0] // m) + m * avg \
            + m * problem.lam * problem.reg_grad(w)
        tab[ib] = th_new[last_occurrence(ib)]
        return w - lr * mask * v, tab, avg + raw / n
    return step


def _read(x):
    return lambda w, ib: x[ib] @ w


def _saga_read(x):
    return lambda state, ib: x[ib] @ state[0]


def pipelined_sgd_epoch(problem: Problem, w, x, y, lr, mask, idx):
    """Pipelined VFB²-SGD over the (steps, B) schedule ``idx``."""
    return _rounds(_sgd_round(problem, x, y, lr, mask, 1), w, _read(x), idx,
                   True)


def pipelined_svrg_epoch(problem: Problem, w, w_snap, mu, x, y, lr, mask,
                         idx):
    """Pipelined VFB²-SVRG inner loop: ϑ₁ rides the stale read; the
    snapshot is constant, so ϑ₀ is delay-free."""
    return _rounds(_svrg_round(problem, w_snap, mu, x, y, lr, mask, 1), w,
                   _read(x), idx, True)


def pipelined_saga_epoch(problem: Problem, w, theta_tab, avg, x, y, lr,
                         mask, idx):
    """Pipelined VFB²-SAGA: the table's reads and writes stay at
    application time; only the forward read of the iterate is one step
    stale.  Returns (w, theta_tab, avg); the input table is not
    modified."""
    return _rounds(_saga_round(problem, x, y, lr, mask, 1),
                   (w, theta_tab.clone(), avg), _saga_read(x), idx, True)


def multi_sgd_epoch(problem: Problem, w, x, y, lr, mask, idx, m: int):
    """VFB²-SGD with m concurrent dominators per round over the
    (steps, m·B) schedule ``idx``."""
    return _rounds(_sgd_round(problem, x, y, lr, mask, m), w, _read(x), idx,
                   False)


def multi_svrg_epoch(problem: Problem, w, w_snap, mu, x, y, lr, mask, idx,
                     m: int):
    """Multi-dominator VFB²-SVRG inner loop: each dominator evaluates the
    iterate and the snapshot on its own minibatch."""
    return _rounds(_svrg_round(problem, w_snap, mu, x, y, lr, mask, m), w,
                   _read(x), idx, False)


def multi_saga_epoch(problem: Problem, w, theta_tab, avg, x, y, lr, mask,
                     idx, m: int):
    """Multi-dominator VFB²-SAGA: all m dominators read (w, table, avg) of
    the round; the table takes all m·B writes, the last occurrence of a
    duplicate id winning."""
    return _rounds(_saga_round(problem, x, y, lr, mask, m),
                   (w, theta_tab.clone(), avg), _saga_read(x), idx, False)


def multi_pipelined_sgd_epoch(problem: Problem, w, x, y, lr, mask, idx,
                              m: int):
    """Pipelined multi-dominator VFB²-SGD: all m dominators' ϑ of round t
    come from the same stale read."""
    return _rounds(_sgd_round(problem, x, y, lr, mask, m), w, _read(x), idx,
                   True)


def multi_pipelined_svrg_epoch(problem: Problem, w, w_snap, mu, x, y, lr,
                               mask, idx, m: int):
    """Pipelined multi-dominator VFB²-SVRG inner loop."""
    return _rounds(_svrg_round(problem, w_snap, mu, x, y, lr, mask, m), w,
                   _read(x), idx, True)


def multi_pipelined_saga_epoch(problem: Problem, w, theta_tab, avg, x, y,
                               lr, mask, idx, m: int):
    """Pipelined multi-dominator VFB²-SAGA (all m·B table writes at
    application time; the last occurrence of a duplicate id wins)."""
    return _rounds(_saga_round(problem, x, y, lr, mask, m),
                   (w, theta_tab.clone(), avg), _saga_read(x), idx, True)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    w: np.ndarray
    history: List[dict]  # per-epoch: objective, epoch, algo
    # deep runs carry the full DeepVFLParams here; ``w`` is then the
    # shared head vector (the active parties' model)
    params: object = None
    # supervised runs (supervise=True) record every divergence rollback
    # here (core.supervisor.HealEvent dicts); an empty list: no heals
    heals: Optional[List[dict]] = None


def _eval(problem, w, x, y):
    return float(torch.mean(problem.loss(x @ w, y))
                 + problem.lam * torch.sum(problem.reg(w)))


def _resume_hist(objs, ep0, algo, engine=None):
    """The per-epoch history entries recorded before a preemption."""
    hist = []
    for i in range(ep0):
        entry = {"epoch": i + 1, "objective": float(objs[i]), "algo": algo}
        if engine is not None:
            entry["engine"] = engine
        hist.append(entry)
    return hist


def _restore(resume_from, state):
    """``(state, ep0)``: the state restored from ``resume_from``'s newest
    bundle (numpy leaves in ``state``'s structure) and the epoch it was
    saved after; ``state`` itself and 0 without ``resume_from``.  The
    checkpoint functions are looked up at call time."""
    if resume_from is None:
        return state, 0
    from repro_torch.checkpoint import ckpt
    return ckpt.load_checkpoint(resume_from, state), \
        ckpt.checkpoint_step(resume_from)


def _save(checkpoint_dir, state, ep, keep_last):
    """Checkpoint ``state`` as the bundle of epoch ``ep`` (nothing without
    ``checkpoint_dir``)."""
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import ckpt
        ckpt.save_checkpoint(checkpoint_dir, state, step=ep,
                             keep_last=keep_last)


# (algo, multi_dominator, pipelined) -> the epoch oracle
_ORACLES = {
    ("sgd", False, False): sgd_epoch,
    ("svrg", False, False): svrg_epoch,
    ("saga", False, False): saga_epoch,
    ("sgd", False, True): pipelined_sgd_epoch,
    ("svrg", False, True): pipelined_svrg_epoch,
    ("saga", False, True): pipelined_saga_epoch,
    ("sgd", True, False): multi_sgd_epoch,
    ("svrg", True, False): multi_svrg_epoch,
    ("saga", True, False): multi_saga_epoch,
    ("sgd", True, True): multi_pipelined_sgd_epoch,
    ("svrg", True, True): multi_pipelined_svrg_epoch,
    ("saga", True, True): multi_pipelined_saga_epoch,
}


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
    multi_dominator: bool = False,  # all m active parties update per round
    pipelined: bool = False,    # τ = 1 backward(t) ∥ forward(t+1) schedule
    deep: bool = False,         # nonlinear party-local encoders (deep VFB²)
    hidden: int = 32,           # deep: encoder hidden width
    d_rep: int = 16,            # deep: aggregated representation width
    deep_params=None,           # deep: DeepVFLParams warm start (w0 analogue)
    checkpoint_dir: Optional[str] = None,  # atomic per-epoch checkpoints
    resume_from: Optional[str] = None,     # bit-exact preemption resume
    keep_last: Optional[int] = 1,          # checkpoint ring depth
    supervise: bool = False,               # divergence rollback supervisor
    supervisor_config=None,     # core.supervisor.SupervisorConfig
    horizon_epochs: Optional[int] = None,  # objs allocation horizon
    device="cuda",
) -> TrainResult:
    """Train a linear VFB² model for ``epochs`` epochs of ``algo`` in
    {"sgd", "svrg", "saga"} on ``device`` (default the card; raises
    without one, so the CPU runs only when asked for).  ``deep=True``
    trains the deep model instead (``algo`` in {"sgd", "svrg"}; see
    :func:`_train_deep`).

    ``x`` (n, d) and ``y`` (n,) are numpy arrays or tensors.  Epoch ``ep``
    runs the schedule ``epoch_indices(seed, ep, n, batch, n // batch)``
    on either engine (``multi_dominator=True``: ``m·batch`` ids per step
    for the layout's m dominators, ``epoch_indices(seed, ep, n, m*batch,
    n // batch)``), so ``engine="fused"`` and ``engine="reference"``
    agree to float tolerance.  ``pipelined=True`` runs the τ = 1
    schedule.  The fused engine's masks are seeded from ``(seed, ep)``.
    ``history`` holds each epoch's full objective.

    ``checkpoint_dir=`` atomically checkpoints the trainer's state after
    every epoch — the iterate (or the deep parameters), the objectives so
    far (NaN-filled to ``horizon_epochs``), SAGA's ϑ̃ table and average —
    keeping the newest ``keep_last`` bundles (``None`` keeps all).  Since
    an epoch is a function of that state and ``(seed, ep)``, the state
    holds no generator; ``resume_from=`` restores it and continues from
    the epoch after it, bit for bit the uninterrupted run, its history
    rebuilt from the stored objectives.

    ``supervise=True`` hands the run to ``core.supervisor``: training
    proceeds in ring-depth segments, the objective trajectory is watched
    for divergence (non-finite, or a spike over a trailing window), and a
    diverged run is rolled back to the last healthy checkpoint with the
    learning rate backed off, under a bounded retry budget.  It needs
    ``checkpoint_dir=``; the rollbacks ride ``result.heals``."""
    if supervise:
        from repro_torch.core.supervisor import supervised_train  # cycle
        return supervised_train(
            problem, x, y, layout, algo=algo, epochs=epochs, lr=lr,
            batch=batch, seed=seed, active_only=active_only, w0=w0,
            engine=engine, engine_config=engine_config,
            multi_dominator=multi_dominator, pipelined=pipelined,
            deep=deep, hidden=hidden, d_rep=d_rep,
            deep_params=deep_params, checkpoint_dir=checkpoint_dir,
            config=supervisor_config, device=device)
    ck = dict(checkpoint_dir=checkpoint_dir, resume_from=resume_from,
              keep_last=keep_last, horizon_epochs=horizon_epochs)
    if deep:
        if w0 is not None:
            raise ValueError("deep VFB² has no flat w0; pass deep_params="
                             "(a DeepVFLParams) to warm-start")
        return _train_deep(problem, x, y, layout, algo, epochs, lr, batch,
                           seed, active_only, engine, engine_config,
                           multi_dominator, pipelined, hidden, d_rep,
                           deep_params, resolve_device(device), **ck)
    if algo not in ("sgd", "svrg", "saga"):
        raise ValueError(f"unknown algo {algo}")
    dev = resolve_device(device)
    n, d = x.shape
    m = layout.m
    steps = max(1, n // batch)
    rows = m * batch if multi_dominator else batch
    if engine == "fused":
        return _train_fused(problem, x, y, layout, algo, epochs, lr, batch,
                            seed, active_only, w0, engine_config,
                            multi_dominator, pipelined, dev, **ck)
    if engine != "reference":
        raise ValueError(f"unknown engine {engine}")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w = torch.zeros(d, dtype=torch.float32, device=dev) if w0 is None \
        else torch.as_tensor(w0, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(layout.update_mask(d, active_only), device=dev)
    st = {"w": w, "objs": np.full(max(horizon_epochs or 0, epochs), np.nan)}
    if algo == "saga":
        st["tab"], st["avg"] = saga_init(problem, w, x, y)
    st, ep0 = _restore(resume_from, st)
    st = {k: v if k == "objs" else torch.as_tensor(v, device=dev)
          for k, v in st.items()}
    hist = _resume_hist(st["objs"], ep0, algo)
    fn = _ORACLES[algo, multi_dominator, pipelined]
    extra = (m,) if multi_dominator else ()
    for ep in range(ep0, epochs):
        idx = epoch_indices(seed, ep, n, rows, steps, dev)
        w = st["w"]
        if algo == "sgd":
            st["w"] = fn(problem, w, x, y, lr, mask, idx, *extra)
        elif algo == "svrg":
            mu = full_gradient(problem, w, x, y)
            st["w"] = fn(problem, w, w, mu, x, y, lr, mask, idx, *extra)
        else:
            st["w"], st["tab"], st["avg"] = fn(problem, w, st["tab"],
                                               st["avg"], x, y, lr, mask,
                                               idx, *extra)
        hist.append({"epoch": ep + 1,
                     "objective": _eval(problem, st["w"], x, y),
                     "algo": algo})
        st["objs"][ep] = hist[-1]["objective"]
        _save(checkpoint_dir, st, ep + 1, keep_last)
    return TrainResult(w=st["w"].cpu().numpy(), history=hist)


def _train_fused(problem, x, y, layout, algo, epochs, lr, batch, seed,
                 active_only, w0, engine_config, multi_dominator, pipelined,
                 dev, checkpoint_dir=None, resume_from=None, keep_last=1,
                 horizon_epochs=None) -> TrainResult:
    """Hot-path trainer: the engine's epochs, each a CUDA-graph replay of
    its step on the card with no host sync inside, and one objective
    evaluation (one sync) and, with ``checkpoint_dir``, one checkpoint
    after each."""
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    n, d = x.shape
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, active_only=active_only,
                      device=dev)
    steps = max(1, n // batch)
    rows = layout.m * batch if multi_dominator else batch
    fn = getattr(eng, ("multi_" if multi_dominator else "")
                 + ("pipelined_" if pipelined else "") + f"{algo}_epoch")
    st = {"wq": eng.pack_w(np.zeros(d, np.float32) if w0 is None else w0),
          "objs": np.full(max(horizon_epochs or 0, epochs), np.nan)}
    if algo == "saga":
        st["tabq"], st["avgq"] = eng.saga_init(st["wq"], (seed,))
    st, ep0 = _restore(resume_from, st)
    st = {k: v if k == "objs" else torch.as_tensor(v, device=eng.device)
          for k, v in st.items()}
    hist = _resume_hist(st["objs"], ep0, algo, engine="fused")
    for ep in range(ep0, epochs):
        idx = epoch_indices(seed, ep, n, rows, steps, dev)
        key = (seed, ep)
        wq = st["wq"]
        if algo == "sgd":
            st["wq"] = fn(wq, lr, idx, key)
        elif algo == "svrg":
            st["wq"] = fn(wq, wq, eng.full_gradient(wq, key), lr, idx, key)
        else:
            st["wq"], st["tabq"], st["avgq"] = fn(wq, st["tabq"],
                                                  st["avgq"], lr, idx, key)
        hist.append({"epoch": ep + 1, "objective": eng.objective(st["wq"]),
                     "algo": algo, "engine": "fused"})
        st["objs"][ep] = hist[-1]["objective"]
        _save(checkpoint_dir, st, ep + 1, keep_last)
    return TrainResult(w=eng.unpack_w(st["wq"]), history=hist)


def _train_deep(problem, x, y, layout, algo, epochs, lr, batch, seed,
                active_only, engine, engine_config, multi_dominator,
                pipelined, hidden, d_rep, deep_params, dev,
                checkpoint_dir=None, resume_from=None, keep_last=1,
                horizon_epochs=None) -> TrainResult:
    """Deep VFB²: party-local two-layer encoders.  ``engine="reference"``
    runs ``core.deep_vfl.train_deep_vfl`` (the sequential oracle),
    ``engine="fused"`` the engine's ``deep_*_epoch`` methods; both start
    from ``deep_params`` (default ``deep_vfl.initial_params(seed, ...)``)
    and run epoch ``ep``'s schedule ``epoch_indices(seed, ep, n, rows,
    n // batch)``, so they agree to float tolerance.
    ``active_only=True`` freezes the passive encoders.  ``w`` in the result
    is the head; the full ``DeepVFLParams`` ride ``result.params``.  The
    checkpoint arguments as in :func:`train` (the state: the parameters
    and the objectives)."""
    from repro_torch.core import deep_vfl  # lazy: deep_vfl imports this

    if algo not in ("sgd", "svrg"):
        raise ValueError(f"deep VFB² supports algo in ('sgd', 'svrg'); "
                         f"got {algo!r}")
    if engine == "reference":
        params, objs = deep_vfl.train_deep_vfl(
            problem, x, y, layout, algo=algo, epochs=epochs, lr=lr,
            batch=batch, seed=seed, hidden=hidden, d_rep=d_rep,
            freeze_passive=active_only, params=deep_params,
            multi_dominator=multi_dominator, pipelined=pipelined,
            checkpoint_dir=checkpoint_dir, resume_from=resume_from,
            keep_last=keep_last, horizon_epochs=horizon_epochs, device=dev)
        hist = [{"epoch": i + 1, "objective": o, "algo": f"deep_{algo}"}
                for i, o in enumerate(objs)]
        return TrainResult(w=params.head.cpu().numpy(), history=hist,
                           params=params)
    if engine != "fused":
        raise ValueError(f"unknown engine {engine}")
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    n, d = x.shape
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, active_only=active_only,
                      device=dev)
    if deep_params is None:
        deep_params = deep_vfl.initial_params(seed, layout, d, hidden, d_rep)
    steps = max(1, n // batch)
    rows = layout.m * batch if multi_dominator else batch
    name = ("multi_" if multi_dominator else "") \
        + ("pipelined_" if pipelined else "") + algo
    fn = getattr(eng, f"deep_{name}_epoch")
    st = {"pq": eng.pack_deep(deep_params),
          "objs": np.full(max(horizon_epochs or 0, epochs), np.nan)}
    st, ep0 = _restore(resume_from, st)
    pq = tuple(torch.as_tensor(a, device=eng.device) for a in st["pq"])
    objs = st["objs"]
    hist = _resume_hist(objs, ep0, f"deep_{algo}", engine="fused")
    for ep in range(ep0, epochs):
        idx = epoch_indices(seed, ep, n, rows, steps, dev)
        key = (seed, ep)
        if algo == "sgd":
            pq = fn(pq, lr, idx, key)
        else:  # the snapshot aliases the live iterate
            pq = fn(pq, pq, eng.deep_full_gradient(pq, key), lr, idx, key)
        hist.append({"epoch": ep + 1, "objective": eng.deep_objective(pq),
                     "algo": f"deep_{algo}", "engine": "fused"})
        objs[ep] = hist[-1]["objective"]
        _save(checkpoint_dir, {"pq": pq, "objs": objs}, ep + 1, keep_last)
    params = eng.unpack_deep(pq)
    return TrainResult(w=params.head.cpu().numpy(), history=hist,
                       params=params)


def accuracy(w, x, y) -> float:
    pred = np.sign(np.asarray(x) @ np.asarray(w))
    pred[pred == 0] = 1
    return float((pred == np.asarray(y)).mean())


def rmse(w, x, y) -> float:
    err = np.asarray(x) @ np.asarray(w) - np.asarray(y)
    return float(np.sqrt(np.mean(err ** 2)))
