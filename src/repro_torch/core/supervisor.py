"""The self-healing training supervisor: divergence rollback and adaptive τ.

The port of ``repro.core.supervisor``.  The guarded epochs
(``core.faults``, ``FusedEngine.guarded_*``) measure health and contain
non-finite partials; nothing in the hot path reacts to a run that goes
wrong slowly (a ×10³ blown-up partial is finite and only shows as a loss
spike later).  This module watches the per-epoch objective (and, for
guarded runs, the :class:`~repro_torch.core.faults.HealthStats` stream),
detects divergence and heals by rolling back to the last healthy atomic
checkpoint:

* **Detection** — an epoch diverged when its objective is non-finite, or
  above ``spike_factor`` × the median of the trailing ``window`` epochs
  (the pre-training objective stands in for epoch 0's trail).  Guarded
  runs also flag any step where a non-finite partial entered the
  aggregate (``finite == 0`` while the party was live: only possible
  with ``guard=False``).
* **Rollback** — training runs in segments of ``keep_last − 1`` epochs
  against a ring of per-epoch checkpoints (``checkpoint.ckpt``), so the
  epoch before the first diverged one is still in the ring; healing
  unlinks every newer bundle (``discard_after``) and resumes from the
  last healthy one, whose state is bit for bit the one saved there.
* **Backoff** — each heal multiplies the learning rate by ``lr_backoff``;
  past ``max_retries`` heals a :class:`DivergenceError` ends the run.
* **Guard escalation** — a non-finite partial in the aggregate of a
  ``guard=False`` run would re-poison the retry; with
  ``guard_escalation=True`` the retry turns the quarantine on instead of
  shrinking the learning rate.
* **Adaptive τ** — when diverged epochs saw strictly larger realized
  delays (base + straggle) than healthy ones, the effective bound
  tightens by ``tau_backoff`` and the base delays are clamped to it (the
  ring keeps its τ+1 slots, so every checkpoint keeps its shape).

``algorithms.train(..., supervise=True)`` routes through
:func:`supervised_train` (linear and deep, both engines);
:func:`supervised_guarded_run` wraps the guarded fault runner with the
same loop, the health diagnosis and the τ controller.  The objectives it
reads are computed in torch on the run's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device


class DivergenceError(RuntimeError):
    """Raised when the retry budget is spent without a healthy run."""


@dataclasses.dataclass
class SupervisorConfig:
    window: int = 3            # trailing epochs for the spike baseline
    spike_factor: float = 5.0  # objective > factor × trailing median
    max_retries: int = 3       # heal budget before DivergenceError
    lr_backoff: float = 0.5    # lr multiplier per heal
    tau_backoff: int = 1       # τ_eff decrement per delay-correlated heal
    keep_last: int = 4         # checkpoint ring depth (≥ 2)
    guard_escalation: bool = True  # turn guard on after aggregate poisoning

    def __post_init__(self):
        if self.keep_last < 2:
            raise ValueError("supervised runs need keep_last >= 2 (the "
                             "rollback target must stay in the ring)")
        if self.window < 1 or self.spike_factor <= 1.0:
            raise ValueError("window >= 1 and spike_factor > 1 required")

    @property
    def chunk(self) -> int:
        """Epochs per segment: with ``keep_last − 1`` a segment, the epoch
        before the first divergence in it is still in the ring."""
        return self.keep_last - 1


def first_divergence(objs: Sequence[float], cfg: SupervisorConfig,
                     base0: Optional[float] = None) -> Optional[int]:
    """Index of the first diverged epoch of an objective trajectory
    (non-finite, or above ``spike_factor`` × the trailing window's
    median).  ``base0``, the objective before training, gives an epoch
    that diverges at once (no trailing epochs yet) a baseline."""
    for i, o in enumerate(objs):
        if not np.isfinite(o):
            return i
        trail = list(objs[max(0, i - cfg.window):i])
        if not trail and base0 is not None and np.isfinite(base0):
            trail = [base0]
        if trail:
            base = float(np.median(trail))
            if np.isfinite(base) and o > cfg.spike_factor * max(base, 1e-12):
                return i
    return None


def poisoned_steps(health) -> np.ndarray:
    """(q, steps) bool: a non-finite partial entered the aggregate.
    ``finite == 0`` alone is a corruption event (the guard quarantines
    it); poisoning is ``finite == 0`` while the party stayed live."""
    fin = np.asarray(health.finite)
    alive = np.asarray(health.alive)
    return (fin == 0) & (alive > 0)


def delay_correlated(realized: Sequence[float], diverged: Sequence[int],
                     total: int) -> bool:
    """True when diverged epochs saw strictly larger realized delays than
    healthy ones (the adaptive-τ trigger)."""
    diverged = set(int(e) for e in diverged)
    bad = [realized[e] for e in diverged if e < len(realized)]
    good = [realized[e] for e in range(min(total, len(realized)))
            if e not in diverged]
    if not bad or not good:
        return False
    return float(np.mean(bad)) > float(np.mean(good))


@dataclasses.dataclass
class HealEvent:
    attempt: int
    diverged_epoch: int        # 1-based epoch that tripped detection
    rollback_step: int         # checkpoint step resumed from (0 = fresh)
    reason: str                # "nonfinite" | "spike" | "poisoned"
    lr: float                  # lr after the backoff
    tau_eff: Optional[int] = None  # τ bound after tightening (guarded)
    guard: Optional[bool] = None   # guard state after escalation

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Supervisor:
    """The retry budget's bookkeeping, shared by both supervised loops."""

    def __init__(self, cfg: Optional[SupervisorConfig] = None):
        self.cfg = cfg or SupervisorConfig()
        self.heals: List[HealEvent] = []

    def charge(self, event: HealEvent) -> HealEvent:
        self.heals.append(event)
        if len(self.heals) > self.cfg.max_retries:
            raise DivergenceError(
                f"training still diverging after {self.cfg.max_retries} "
                f"rollbacks (last: epoch {event.diverged_epoch}, "
                f"{event.reason})")
        return event


def _rollback(checkpoint_dir: str, step: int) -> Optional[str]:
    """Discard every bundle newer than ``step``; None: a fresh start."""
    from repro_torch.checkpoint.ckpt import discard_after

    discard_after(checkpoint_dir, step)
    return checkpoint_dir if step > 0 else None


def supervised_train(problem, x, y, layout, *, algo: str = "svrg",
                     epochs: int = 20, lr: float = 0.5, batch: int = 32,
                     seed: int = 0, active_only: bool = False, w0=None,
                     engine: str = "fused", engine_config=None,
                     multi_dominator: bool = False, pipelined: bool = False,
                     deep: bool = False, hidden: int = 32, d_rep: int = 16,
                     deep_params=None, checkpoint_dir: Optional[str] = None,
                     config: Optional[SupervisorConfig] = None,
                     device="cuda"):
    """``algorithms.train`` under supervision (``train(...,
    supervise=True)``, linear and deep) on ``device`` (default the card;
    raises without one).  Training runs in ring-depth segments; after
    each, the objective trajectory is diagnosed and a diverged run rolled
    back to the last healthy checkpoint with the learning rate backed
    off.  Returns the final ``TrainResult``, ``result.heals`` recording
    every rollback."""
    from repro_torch.core.algorithms import train  # cycle

    if checkpoint_dir is None:
        raise ValueError("supervise=True needs checkpoint_dir= (the "
                         "rollback ring lives there)")
    dev = resolve_device(device)
    sup = Supervisor(config)
    cfg = sup.cfg
    lr_now = float(lr)
    # the objective before training: the spike baseline of an epoch-0
    # blowup (the trainers' start: zeros / w0, the seeded deep init)
    if deep:
        from repro_torch.core import deep_vfl

        d = np.shape(x)[1]
        p0 = deep_params if deep_params is not None else \
            deep_vfl.initial_params(seed, layout, d, hidden, d_rep)
        base0 = _deep_objective(problem, p0, x, y, layout, dev)
    else:
        wz = np.zeros(np.shape(x)[1], np.float32) if w0 is None else w0
        base0 = _linear_objective(problem, wz, x, y, dev)
    done, resume, res = 0, None, None
    while done < epochs:
        seg_end = min(done + cfg.chunk, epochs)
        res = train(problem, x, y, layout, algo=algo, epochs=seg_end,
                    lr=lr_now, batch=batch, seed=seed,
                    active_only=active_only, w0=w0, engine=engine,
                    engine_config=engine_config,
                    multi_dominator=multi_dominator, pipelined=pipelined,
                    deep=deep, hidden=hidden, d_rep=d_rep,
                    deep_params=deep_params, checkpoint_dir=checkpoint_dir,
                    resume_from=resume, keep_last=cfg.keep_last,
                    horizon_epochs=epochs, device=dev)
        objs = [h["objective"] for h in res.history]
        bad = first_divergence(objs, cfg, base0=base0)
        if bad is None:
            done, resume = seg_end, checkpoint_dir
            continue
        target = bad                    # objs[bad] is epoch bad+1's loss
        reason = "nonfinite" if not np.isfinite(objs[bad]) else "spike"
        lr_now *= cfg.lr_backoff
        sup.charge(HealEvent(attempt=len(sup.heals) + 1,
                             diverged_epoch=bad + 1, rollback_step=target,
                             reason=reason, lr=lr_now))
        resume = _rollback(checkpoint_dir, target)
        done = target
    res.heals = [h.as_dict() for h in sup.heals]
    return res


def _linear_objective(problem, w, x, y, device) -> float:
    """The full linear objective at ``w`` (d,), in torch on ``device``."""
    from repro_torch.core.algorithms import _eval

    return _eval(problem, *(torch.as_tensor(a, dtype=torch.float32,
                                            device=device) for a in (w, x, y)))


def _deep_objective(problem, params, x, y, layout, device) -> float:
    """The full deep objective of ``params`` (``DeepVFLParams``), in torch
    on ``device``."""
    from repro_torch.core import deep_vfl

    _, blocks, yt, pt = deep_vfl._setup(x, y, layout, params, 0, 0, 0,
                                        device)
    return deep_vfl._objective(problem, deep_vfl._to_params(pt), blocks, yt)


def realized_epoch_delays(sched, delays_q, steps: int, epochs: int,
                          tau: int) -> np.ndarray:
    """The largest realized (base + straggle) delay of each epoch,
    clamped to τ: the adaptive-τ controller's evidence."""
    extra = np.asarray(sched.extra)
    out = np.zeros(epochs, np.float64)
    for e in range(epochs):
        win = extra[e * steps:(e + 1) * steps]
        real = np.asarray(delays_q)[None, :] + win
        out[e] = float(np.minimum(real, tau).max()) if real.size else 0.0
    return out


def supervised_guarded_run(problem, x, y, layout, trace, tau: int,
                           epochs: int, lr: float, batch: int, *,
                           algo: str = "sgd", seed: int = 0,
                           guard: bool = True, deep: bool = False,
                           hidden: int = 32, d_rep: int = 16,
                           engine_config=None, delays_q=None,
                           checkpoint_dir: Optional[str] = None,
                           config: Optional[SupervisorConfig] = None,
                           device="cuda"):
    """Guarded fault-trace training under supervision, on ``device``
    (default the card; raises without one).

    Wraps ``faults.run_guarded_fused`` in ring-depth segments, diagnosing
    each from the objective and the :class:`HealthStats` stream: a
    non-finite partial that entered the aggregate (only with
    ``guard=False``) heals by turning the guard on for the retry;
    objective spikes heal by the learning-rate backoff; and when diverged
    epochs saw larger realized delays the effective staleness bound
    tightens (the base delays clamped to it).  ``deep=True`` wraps
    ``faults.run_deep_guarded_fused`` (``hidden``, ``d_rep``; the
    objective of the trainers' start ``deep_vfl.initial_params(seed)`` is
    the spike baseline).  Returns ``(w, health, heals)``, ``w`` the final
    ``DeepVFLParams`` under ``deep=True``."""
    from repro_torch.core import faults

    if checkpoint_dir is None:
        raise ValueError("supervised guarded runs need checkpoint_dir=")
    dev = resolve_device(device)
    sup = Supervisor(config)
    cfg = sup.cfg
    n, d = np.shape(x)
    steps = max(1, n // batch)
    sched = faults.as_trace(trace).compile(layout.m)
    base_delays = faults._base_delays(layout, tau, sched, delays_q, seed)
    tau_eff = tau
    lr_now = float(lr)
    guard_now = bool(guard)
    if deep:
        from repro_torch.core import deep_vfl

        base0 = _deep_objective(problem, deep_vfl.initial_params(
            seed, layout, d, hidden, d_rep), x, y, layout, dev)
    else:
        base0 = _linear_objective(problem, np.zeros(d, np.float32), x, y,
                                  dev)
    done, resume = 0, None
    samples: List[tuple] = []   # (epoch boundary, objective) per segment
    diverged_eps: List[int] = []
    result = health = None
    while done < epochs:
        seg_end = min(done + cfg.chunk, epochs)
        run = faults.run_deep_guarded_fused if deep \
            else faults.run_guarded_fused
        kw = dict(hidden=hidden, d_rep=d_rep) if deep else {}
        result, health = run(
            problem, x, y, layout, trace, tau, seg_end, lr_now, batch,
            algo=algo, seed=seed, guard=guard_now,
            delays_q=np.minimum(base_delays, tau_eff),
            engine_config=engine_config, checkpoint_dir=checkpoint_dir,
            resume_from=resume, keep_last=cfg.keep_last,
            horizon_epochs=epochs, device=dev, **kw)
        obj = _deep_objective(problem, result, x, y, layout, dev) if deep \
            else _linear_objective(problem, result, x, y, dev)
        samples.append((seg_end, obj))
        # the health diagnosis first: poisoning names the exact epoch
        pois = poisoned_steps(health)
        pois[:, seg_end * steps:] = False
        bad_ep: Optional[int] = None
        reason = None
        if pois.any():
            bad_ep = int(np.argwhere(pois.any(axis=0))[0, 0]) // steps
            reason = "poisoned"
        else:
            objs = [o for _, o in samples]
            if first_divergence(objs, cfg, base0=base0) == len(objs) - 1:
                bad_ep = done          # blame the segment's first epoch
                reason = "nonfinite" if not np.isfinite(obj) else "spike"
        if bad_ep is None:
            done, resume = seg_end, checkpoint_dir
            continue
        diverged_eps.append(bad_ep)
        if reason == "poisoned" and cfg.guard_escalation and not guard_now:
            guard_now = True           # quarantine instead of re-poisoning
        else:
            lr_now *= cfg.lr_backoff
        realized = realized_epoch_delays(sched, base_delays, steps, epochs,
                                         tau)
        if delay_correlated(realized, diverged_eps, seg_end) \
                and tau_eff > 0:
            tau_eff = max(0, tau_eff - cfg.tau_backoff)
        sup.charge(HealEvent(attempt=len(sup.heals) + 1,
                             diverged_epoch=bad_ep + 1,
                             rollback_step=bad_ep, reason=reason,
                             lr=lr_now, tau_eff=tau_eff, guard=guard_now))
        resume = _rollback(checkpoint_dir, bad_ep)
        done = bad_ep
        samples = [(e, o) for e, o in samples if e <= bad_ep]
    return result, health, [h.as_dict() for h in sup.heals]
