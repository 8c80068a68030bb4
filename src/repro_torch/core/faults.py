"""Deterministic fault traces — crash, rejoin, straggle, dropped broadcast
and corrupt value — with the faulted and guarded linear and deep epochs.

The port of ``repro.core.faults``.  A :class:`FaultTrace` is a
list of per-(party, step) events; ``compile`` turns it into dense per-step
channels that the engine's faulted and guarded epochs read inside each
captured step, and that the sequential oracles here read per coordinate.

Fault model (each event at step t):

``crash(p)``
    Party p is gone until its ``rejoin``: no forward partial (the
    aggregate is the survivor sum, the masks re-drawn over the survivors:
    ``secure_agg.secure_psum_members`` / ``secure_psum_ring_members``), no
    gradient, nothing written into its ring, no update — its block
    freezes.  A crash is an unbounded delay.
``rejoin(p)``
    Party p is back.  Its ring still holds its last pre-crash gradients,
    so its first applications replay them until fresh writes age through.
    The replicated state (SAGA's ϑ̃ table) was kept current by the
    survivors; the party-private state that missed updates (SAGA's
    running average) is not recovered.
``straggle(p, k)``
    Party p's application at step t uses the gradient of step
    t − (d_p + k): k is added to its base delay for that step (the runners
    check d_p + k ≤ τ).
``drop_msg(p)``
    The dominator's ϑ broadcast to p is lost: p contributed its forward
    partial but computes, writes and applies nothing at step t.
``corrupt(p, mode)``
    p's forward partial is corrupted before aggregation: ``nan``, ``inf``
    (+Inf) or ``blowup`` (×10³).  Unguarded, a non-finite partial poisons
    the masked aggregate for every party.  With ``guard=True`` the guarded
    epochs quarantine it: the party leaves the step's forward alive set
    (its partial zeroed by ``where`` before the survivor sum — 0·NaN is
    NaN), and otherwise proceeds.  A blowup is finite and passes; the
    supervisor catches it from the norm telemetry (:class:`HealthStats`).

Every step needs at least one active party (p < m) alive to compute ϑ;
``FaultTrace.compile`` checks it.

* The oracles ``faulted_{sgd,svrg,saga}_epoch`` and
  ``guarded_{sgd,svrg,saga}_epoch`` are plain torch, dtype-generic, on the
  pooled (n, d) data in coordinate space, over an explicit ``(steps, B)``
  schedule ``idx`` (the reference draws one from its key).
* ``run_faulted_reference`` / ``run_guarded_reference`` drive the oracles,
  and ``run_faulted_fused`` / ``run_guarded_fused`` the engine's epochs
  (each a CUDA-graph replay of its step on the card), on the same start,
  schedules ``epoch_indices(seed, ep, …)`` and delays; the fused runners
  checkpoint after every epoch (``checkpoint_dir=``) and resume bit for
  bit (``resume_from=``).
* A trace of the JAX package (any object with ``q``, ``steps`` and
  ``events`` carrying ``step/party/kind/k/mode``) feeds the runners as
  well.

Deep (each party a two-layer encoder, the head dominator-held): the
crash, straggle and drop channels gate each party's encoder rings (w1,
b1, w2) and updates as above, the corrupt channel acts on the party's
(B, d_rep) vector partial, and the replicated head applies its gradient
fresh at every step.

* The deep oracles ``deep_{faulted,guarded}_{sgd,svrg}_epoch`` are party
  loops on the per-party feature blocks, in the parameters' dtype (float64
  included), on the delayed deep oracle's rings
  (``staleness._deep_ring_apply``).
* ``run_deep_faulted_reference`` / ``run_deep_guarded_reference`` drive
  them, ``run_deep_faulted_fused`` / ``run_deep_guarded_fused`` the
  engine's deep faulted and guarded epochs, from
  ``deep_vfl.initial_params(seed)``; the fused runners checkpoint and
  resume as the linear ones do.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import (PartyLayout, epoch_indices,
                                         full_gradient, last_occurrence,
                                         saga_init)
from repro_torch.core.deep_vfl import (DeepVFLParams, _bum_grads,
                                       _bum_stale_grads, _combine, _schedules,
                                       _to_params)
from repro_torch.core.deep_vfl import _setup as _deep_setup
from repro_torch.core.losses import Problem
from repro_torch.core.staleness import _deep_ring_apply, party_delay_values

KINDS = ("crash", "rejoin", "straggle", "drop_msg", "corrupt")

# corrupt-value modes and their dense codes (0 = no corruption)
CORRUPT_MODES = ("nan", "inf", "blowup")
CORRUPT_CODES = {"nan": 1, "inf": 2, "blowup": 3}
BLOWUP_FACTOR = 1e3


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault at one (step, party).  ``k`` is straggle's extra delay;
    ``mode`` is corrupt's value class (``nan``/``inf``/``blowup``)."""

    step: int
    party: int
    kind: str
    k: int = 0
    mode: str = ""


def apply_corruption(z: torch.Tensor, code) -> torch.Tensor:
    """Corrupt a forward partial by its code (broadcast against ``z``):
    0 untouched, 1 NaN, 2 +Inf, 3 ×10³.  The one definition the oracles
    and the engine's guarded epochs both run."""
    code = torch.as_tensor(code, device=z.device)
    z = torch.where(code == 3, BLOWUP_FACTOR * z, z)
    z = torch.where(code == 1, torch.full_like(z, float("nan")), z)
    return torch.where(code == 2, torch.full_like(z, float("inf")), z)


class HealthStats(NamedTuple):
    """Per-(party, step) health telemetry, (q, steps) each: the guarded
    epochs write it inside the captured step (no host read), and the
    guarded oracles give the same arrays.  ``finite``/``alive`` are
    protocol-public (a masked partial is non-finite iff the raw one is);
    the norms are party-local diagnostics for the supervisor."""

    finite: object   # 1.0 ⇔ the party's shipped partial was finite
    alive: object    # effective forward liveness (after quarantine)
    pnorm: object    # max |·| of the (possibly corrupted) partial
    gnorm: object    # max |·| of the update direction entering the ring

    @staticmethod
    def concat(parts: Sequence["HealthStats"]) -> "HealthStats":
        """Stitch per-epoch stats along the step axis, as numpy."""
        return HealthStats(*(np.concatenate([_host(a) for a in leaf], axis=1)
                             for leaf in zip(*parts)))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """A deterministic fault schedule over ``steps`` global steps."""

    q: int
    steps: int
    events: Tuple[FaultEvent, ...] = ()

    def with_steps(self, steps: int) -> "FaultTrace":
        """The same events over another step horizon."""
        return FaultTrace(q=self.q, steps=steps, events=self.events)

    def compile(self, m: Optional[int] = None) -> "FaultSchedule":
        """Dense (steps, q) channels: forward and backward liveness,
        straggle's extra delay and the corrupt codes.

        Checks that every event is legal (no crash of a crashed party, no
        rejoin of a live one, no other event of a crashed one) and, when
        ``m`` is given, that some active party (p < m) is alive at every
        step."""
        fwd = np.ones((self.steps, self.q), np.float32)
        bwd = np.ones((self.steps, self.q), np.float32)
        extra = np.zeros((self.steps, self.q), np.int32)
        corrupt = np.zeros((self.steps, self.q), np.int32)
        down = np.zeros(self.q, bool)
        for ev in sorted(self.events, key=lambda e: (e.step, e.party)):
            if ev.kind not in KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
            if not (0 <= ev.party < self.q):
                raise ValueError(f"party {ev.party} out of range")
            if not (0 <= ev.step < self.steps):
                raise ValueError(
                    f"step {ev.step} outside trace horizon {self.steps}")
            if ev.kind == "crash":
                if down[ev.party]:
                    raise ValueError(
                        f"party {ev.party} crashed twice (step {ev.step})")
                down[ev.party] = True
                fwd[ev.step:, ev.party] = 0.0
                bwd[ev.step:, ev.party] = 0.0
            elif ev.kind == "rejoin":
                if not down[ev.party]:
                    raise ValueError(
                        f"rejoin of live party {ev.party} (step {ev.step})")
                down[ev.party] = False
                fwd[ev.step:, ev.party] = 1.0
                bwd[ev.step:, ev.party] = 1.0
            elif down[ev.party]:
                raise ValueError(
                    f"{ev.kind} of crashed party {ev.party} "
                    f"(step {ev.step})")
            elif ev.kind == "straggle":
                if ev.k < 0:
                    raise ValueError("straggle needs k >= 0")
                extra[ev.step, ev.party] = ev.k
            elif ev.kind == "corrupt":
                if ev.mode not in CORRUPT_MODES:
                    raise ValueError(
                        f"corrupt needs mode in {CORRUPT_MODES}, got "
                        f"{ev.mode!r} (step {ev.step}, party {ev.party})")
                corrupt[ev.step, ev.party] = CORRUPT_CODES[ev.mode]
            else:  # drop_msg
                bwd[ev.step, ev.party] = 0.0
        if fwd.sum(axis=1).min() < 1.0:
            raise ValueError("every step needs >= 1 surviving party")
        if m is not None and fwd[:, :m].sum(axis=1).min() < 1.0:
            raise ValueError(
                "dominator availability violated: some step has no "
                f"active party (p < {m}) alive to compute ϑ")
        return FaultSchedule(fwd=fwd, bwd=bwd, extra=extra, corrupt=corrupt)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A compiled trace: (steps, q) per-step channels."""

    fwd: np.ndarray     # (steps, q) f32 — contributes its forward partial
    bwd: np.ndarray     # (steps, q) f32 — receives ϑ, writes and applies
    extra: np.ndarray   # (steps, q) i32 — straggle's added delay
    corrupt: Optional[np.ndarray] = None  # (steps, q) i32 corrupt codes

    def codes(self) -> np.ndarray:
        """Dense (steps, q) int32 corrupt codes (zeros without a channel)."""
        if self.corrupt is None:
            return np.zeros(self.fwd.shape, np.int32)
        return self.corrupt

    def epoch(self, e: int, steps: int) -> "FaultSchedule":
        """The window of epoch ``e`` of ``steps`` steps each."""
        sl = slice(e * steps, (e + 1) * steps)
        return FaultSchedule(fwd=self.fwd[sl], bwd=self.bwd[sl],
                             extra=self.extra[sl], corrupt=self.codes()[sl])

    def party_rows(self):
        """(q, steps) numpy ``(fwd, bwd, extra)``: the engine's party
        layout."""
        return (np.ascontiguousarray(self.fwd.T),
                np.ascontiguousarray(self.bwd.T),
                np.ascontiguousarray(self.extra.T))

    def corrupt_rows(self) -> np.ndarray:
        """(q, steps) int32 corrupt codes: the engine's party layout."""
        return np.ascontiguousarray(self.codes().T)

    def coord_rows(self, layout: PartyLayout, d: int):
        """(steps, d) numpy ``(fwd, bwd, extra)``: the oracles'
        coordinate layout."""
        owner = layout.party_of_coord(d)
        return self.fwd[:, owner], self.bwd[:, owner], self.extra[:, owner]

    def max_extra(self) -> int:
        return int(self.extra.max()) if self.extra.size else 0


def random_trace(layout: PartyLayout, steps: int, *, rate: float = 0.08,
                 max_down: int = 3, max_straggle: int = 2,
                 p_drop: float = 0.05, p_corrupt: float = 0.0,
                 corrupt_modes: Sequence[str] = CORRUPT_MODES,
                 seed: int = 0) -> FaultTrace:
    """A random but deterministic chaos schedule: the reference's events
    for the same arguments (numpy's ``default_rng(seed)``).

    Party 0 (a dominator) never crashes; every crash schedules its rejoin
    at most ``max_down`` steps later (or never, past the horizon).
    ``p_corrupt > 0`` adds corrupt events with modes drawn uniformly from
    ``corrupt_modes``."""
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []
    down_until = {}
    for t in range(steps):
        for p in range(layout.q):
            if p in down_until:
                if down_until[p] == t:
                    events.append(FaultEvent(t, p, "rejoin"))
                    del down_until[p]
                continue
            u = rng.random()
            if p != 0 and u < rate:
                dur = int(rng.integers(1, max_down + 1))
                events.append(FaultEvent(t, p, "crash"))
                down_until[p] = t + dur if t + dur < steps else steps + 1
            elif u < rate + rate:
                events.append(FaultEvent(t, p, "straggle",
                                         k=int(rng.integers(1,
                                                            max_straggle + 1))))
            elif u < rate + rate + p_drop:
                events.append(FaultEvent(t, p, "drop_msg"))
            elif u < rate + rate + p_drop + p_corrupt:
                mode = corrupt_modes[int(rng.integers(len(corrupt_modes)))]
                events.append(FaultEvent(t, p, "corrupt", mode=mode))
    return FaultTrace(q=layout.q, steps=steps, events=tuple(events))


def as_trace(trace) -> FaultTrace:
    """``trace`` as this module's :class:`FaultTrace` (a trace of the JAX
    package has the same fields)."""
    if isinstance(trace, FaultTrace):
        return trace
    return FaultTrace(q=int(trace.q), steps=int(trace.steps), events=tuple(
        FaultEvent(int(e.step), int(e.party), str(e.kind), int(e.k),
                   str(e.mode)) for e in trace.events))


# ---------------------------------------------------------------------------
# sequential oracles (coordinate space)
# ---------------------------------------------------------------------------
#
# The staleness oracles' ring with three per-step per-coordinate channels:
# fc (forward liveness) zeroes a crashed party's block out of the
# aggregate, bc (backward liveness) gates the ring write and the update,
# ec adds straggle's delay to the ring read.  The guarded oracles add the
# party-space corrupt codes cp and take the forward liveness fp per party.

def _ring(buf, t, v, b, dcoord, e):
    """Write ``v`` into slot t mod (τ+1) where ``b`` > 0 (the old row
    elsewhere), then read each coordinate's slot max(t − (d + e), 0)
    mod (τ+1).  Returns (ring, stale)."""
    ring = buf.shape[0]
    slot = (t % ring).view(1)
    row = buf.index_select(0, slot)[0]
    buf = buf.index_copy(0, slot, torch.where(b > 0, v, row)[None])
    eff = (t - (dcoord + e)).clamp_min(0) % ring
    return buf, buf.gather(0, eff[None]).squeeze(0)


def _channels(x, dcoord, *rows):
    """The oracles' integer delays and per-step channels as tensors on
    x's device (floats in x's dtype, delays and codes int64); ``rows``
    are (channel, integer?) pairs."""
    def put(a, integer):
        a = torch.as_tensor(a, device=x.device)
        return a.long() if integer else a.to(x.dtype)

    return (put(dcoord, True),) + tuple(put(a, i) for a, i in rows)


def _t(t0, device) -> torch.Tensor:
    return torch.as_tensor(t0, device=device).long().reshape(())


def faulted_sgd_epoch(problem: Problem, w, buf, t0, x, y, lr, mask, dcoord,
                      idx, fc, bc, ec):
    """One faulted VFB²-SGD epoch (the sequential oracle) over the
    (steps, B) schedule ``idx``; ``fc``/``bc``/``ec`` are (steps, d) and
    ``dcoord`` (d,) the base delays.  Returns ``(w, buf, t)``."""
    dcoord, fc, bc, ec = _channels(x, dcoord, (fc, False), (bc, False),
                                   (ec, True))
    t = _t(t0, x.device)
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb = x[ib]
        theta = problem.theta(xb @ (w * fc[i]), y[ib])   # survivor sum
        g = xb.T @ theta / ib.shape[0] + problem.lam * problem.reg_grad(w)
        buf, stale = _ring(buf, t, g, bc[i], dcoord, ec[i])
        w = w - lr * mask * bc[i] * stale
        t = t + 1
    return w, buf, t


def faulted_svrg_epoch(problem: Problem, w, w_snap, mu, buf, t0, x, y, lr,
                       mask, dcoord, idx, fc, bc, ec):
    """Faulted VFB²-SVRG inner loop: v = g(w) − g(w̃) + μ̃ enters the ring
    and ages like SGD's gradient; both forward reads are survivor sums.
    μ̃ and the snapshot are epoch-boundary rounds over full membership (the
    runners')."""
    dcoord, fc, bc, ec = _channels(x, dcoord, (fc, False), (bc, False),
                                   (ec, True))
    t = _t(t0, x.device)
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb = x[ib]
        th1 = problem.theta(xb @ (w * fc[i]), y[ib])
        th0 = problem.theta(xb @ (w_snap * fc[i]), y[ib])
        g1 = xb.T @ th1 / ib.shape[0] + problem.lam * problem.reg_grad(w)
        g0 = xb.T @ th0 / ib.shape[0] \
            + problem.lam * problem.reg_grad(w_snap)
        buf, stale = _ring(buf, t, g1 - g0 + mu, bc[i], dcoord, ec[i])
        w = w - lr * mask * bc[i] * stale
        t = t + 1
    return w, buf, t


def faulted_saga_epoch(problem: Problem, w, tab, avg, buf, t0, x, y, lr,
                       mask, dcoord, idx, fc, bc, ec):
    """Faulted VFB²-SAGA.  The ϑ̃ table is dominator-held protocol state
    and stays fresh at every step; the per-party running average is
    party-private and freezes while the party is out.  Duplicate ids:
    the last occurrence wins."""
    dcoord, fc, bc, ec = _channels(x, dcoord, (fc, False), (bc, False),
                                   (ec, True))
    t = _t(t0, x.device)
    n = x.shape[0]
    tab = tab.clone()
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb = x[ib]
        th_new = problem.theta(xb @ (w * fc[i]), y[ib])
        raw = xb.T @ (th_new - tab[ib])
        v = raw / ib.shape[0] + avg + problem.lam * problem.reg_grad(w)
        buf, stale = _ring(buf, t, v, bc[i], dcoord, ec[i])
        w = w - lr * mask * bc[i] * stale
        avg = avg + bc[i] * raw / n          # private: frozen while out
        tab[ib] = th_new[last_occurrence(ib)]   # shared: always fresh
        t = t + 1
    return w, tab, avg, buf, t


def _ownership(layout: PartyLayout, d: int, device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    """(d, q) one-hot coordinate ownership."""
    own = torch.zeros((d, layout.q), dtype=dtype, device=device)
    own[torch.arange(d), torch.from_numpy(layout.party_of_coord(d))
        .long()] = 1.0
    return own


def _party_cols(u, own):
    """(B, d) per-coordinate products -> (B, q) per-party partials.  Not a
    plain ``u @ own``: once a party's weights are non-finite (unguarded,
    after poisoning) the one-hot's zeros would leak NaN into every other
    party's column (NaN·0 = NaN), which the per-party engine — each party
    touching its own block only — cannot do.  The ``where`` keeps a
    party's own NaN and blocks the leak."""
    return torch.where(own[None] > 0, u[:, :, None],
                       torch.zeros((), dtype=u.dtype, device=u.device)) \
        .sum(1)


def _guard_partials(zcols, f, c, guard: bool):
    """Corrupt the per-party partial columns (a list of (B, q), or of
    (B, d_rep, q) deep vector partials: SVRG ships the iterate's and the
    snapshot's), then quarantine or not.  Returns (shipped columns,
    corrupted columns, healthy flags, liveness)."""
    zc = [apply_corruption(z, c[None, :]) for z in zcols]
    fin = torch.ones(zc[0].shape[-1], dtype=torch.bool, device=f.device)
    for z in zc:
        fin = fin & torch.isfinite(z).flatten(0, -2).all(0)
    healthy = fin.to(f.dtype)
    if not guard:
        return zc, zc, healthy, f
    return [torch.where(healthy > 0, z, torch.zeros_like(z))
            for z in zc], zc, healthy, f * healthy


def _health(zc, healthy, live, v, own) -> torch.Tensor:
    """One step's (4, q) health columns: finite, alive, the partials' max
    |·| and the direction's max |·| over each party's coordinates."""
    pnorm = torch.stack([z.abs().amax(0) for z in zc]).amax(0)
    gnorm = torch.where(own > 0, v.abs()[:, None],
                        torch.zeros((), dtype=v.dtype,
                                    device=v.device)).amax(0)
    return torch.stack([healthy, live, pnorm, gnorm])


def _stats(cols) -> HealthStats:
    return HealthStats(*torch.stack(cols, 2))


def guarded_sgd_epoch(problem: Problem, w, buf, t0, x, y, lr, mask, dcoord,
                      own, idx, fp, bc, ec, cp, guard: bool = True):
    """One guarded VFB²-SGD epoch (the sequential oracle).  ``fp``/``cp``:
    (steps, q) party-space forward liveness and corrupt codes; ``bc``/
    ``ec``: (steps, d) coordinate-space backward liveness and straggle
    delay; ``own``: the (d, q) ownership one-hot.  Returns ``(w, buf, t,
    HealthStats)``, the telemetry (q, steps) tensors."""
    dcoord, fp, bc, ec, cp = _channels(x, dcoord, (fp, False), (bc, False),
                                       (ec, True), (cp, True))
    t = _t(t0, x.device)
    hs = []
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb = x[ib]
        zs, zc, healthy, live = _guard_partials(
            [_party_cols(xb * w[None, :], own)], fp[i], cp[i], guard)
        theta = problem.theta(zs[0] @ live, y[ib])   # healthy survivors
        g = xb.T @ theta / ib.shape[0] + problem.lam * problem.reg_grad(w)
        buf, stale = _ring(buf, t, g, bc[i], dcoord, ec[i])
        w = w - lr * mask * bc[i] * stale
        hs.append(_health(zc, healthy, live, g, own))
        t = t + 1
    return w, buf, t, _stats(hs)


def guarded_svrg_epoch(problem: Problem, w, w_snap, mu, buf, t0, x, y, lr,
                       mask, dcoord, own, idx, fp, bc, ec, cp,
                       guard: bool = True):
    """Guarded VFB²-SVRG inner loop: a party's forward message is both
    partial columns (iterate and snapshot); one corrupt code rewrites
    both and the finiteness verdict covers both."""
    dcoord, fp, bc, ec, cp = _channels(x, dcoord, (fp, False), (bc, False),
                                       (ec, True), (cp, True))
    t = _t(t0, x.device)
    hs = []
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb = x[ib]
        zs, zc, healthy, live = _guard_partials(
            [_party_cols(xb * w[None, :], own),
             _party_cols(xb * w_snap[None, :], own)], fp[i], cp[i], guard)
        th1 = problem.theta(zs[0] @ live, y[ib])
        th0 = problem.theta(zs[1] @ live, y[ib])
        g1 = xb.T @ th1 / ib.shape[0] + problem.lam * problem.reg_grad(w)
        g0 = xb.T @ th0 / ib.shape[0] \
            + problem.lam * problem.reg_grad(w_snap)
        v = g1 - g0 + mu
        buf, stale = _ring(buf, t, v, bc[i], dcoord, ec[i])
        w = w - lr * mask * bc[i] * stale
        hs.append(_health(zc, healthy, live, v, own))
        t = t + 1
    return w, buf, t, _stats(hs)


def guarded_saga_epoch(problem: Problem, w, tab, avg, buf, t0, x, y, lr,
                       mask, dcoord, own, idx, fp, bc, ec, cp,
                       guard: bool = True):
    """Guarded VFB²-SAGA: the faulted oracle's freshness split (the ϑ̃
    table always fresh, the average gated by backward liveness) with the
    corrupt channel on the forward partial.  Returns ``(w, tab, avg, buf,
    t, HealthStats)``."""
    dcoord, fp, bc, ec, cp = _channels(x, dcoord, (fp, False), (bc, False),
                                       (ec, True), (cp, True))
    t = _t(t0, x.device)
    n = x.shape[0]
    tab = tab.clone()
    hs = []
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb = x[ib]
        zs, zc, healthy, live = _guard_partials(
            [_party_cols(xb * w[None, :], own)], fp[i], cp[i], guard)
        th_new = problem.theta(zs[0] @ live, y[ib])
        raw = xb.T @ (th_new - tab[ib])
        v = raw / ib.shape[0] + avg + problem.lam * problem.reg_grad(w)
        buf, stale = _ring(buf, t, v, bc[i], dcoord, ec[i])
        w = w - lr * mask * bc[i] * stale
        avg = avg + bc[i] * raw / n
        tab[ib] = th_new[last_occurrence(ib)]
        hs.append(_health(zc, healthy, live, v, own))
        t = t + 1
    return w, tab, avg, buf, t, _stats(hs)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

def _check_delay_budget(delays_q, sched: FaultSchedule, tau: int):
    worst = (np.asarray(sched.extra)
             + np.asarray(delays_q)[None, :]).max() if sched.extra.size \
        else np.asarray(delays_q).max()
    if worst > tau:
        raise ValueError(
            f"delay budget exceeded: base + straggle = {int(worst)} > "
            f"τ = {tau}; the (τ+1)-slot ring would alias — raise tau or "
            "shrink the straggle events")


def _base_delays(layout: PartyLayout, tau: int, sched: FaultSchedule,
                 delays_q, seed: int) -> np.ndarray:
    """Per-party base delays keeping base + straggle ≤ τ."""
    if delays_q is None:
        room = max(0, tau - sched.max_extra())
        delays_q = party_delay_values(layout, room, seed)
    delays_q = np.asarray(delays_q, np.int32)
    _check_delay_budget(delays_q, sched, tau)
    return delays_q


def _setup(trace, layout: PartyLayout, n: int, batch: int, epochs: int,
           horizon_epochs, tau: int, delays_q, seed: int):
    """(port trace's schedule, base delays, steps per epoch) after the
    horizon and delay-budget checks."""
    steps = max(1, n // batch)
    horizon = epochs if horizon_epochs is None \
        else max(int(horizon_epochs), epochs)
    trace = as_trace(trace)
    if trace.steps != horizon * steps:
        raise ValueError(f"trace horizon {trace.steps} != horizon*steps "
                         f"= {horizon * steps}")
    sched = trace.compile(layout.m)
    return sched, _base_delays(layout, tau, sched, delays_q, seed), steps


def _oracle_run(problem, x, y, layout, trace, tau, epochs, lr, batch, algo,
                seed, delays_q, active_only, device, guard):
    """The oracle drivers' shared loop; ``guard`` None runs the faulted
    oracles."""
    if algo not in ("sgd", "svrg", "saga"):
        raise ValueError(f"unknown algo {algo}")
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    x = x if x.is_floating_point() else x.float()
    y = torch.as_tensor(y, device=dev).to(x.dtype)
    n, d = x.shape
    sched, delays_q, steps = _setup(trace, layout, n, batch, epochs, None,
                                    tau, delays_q, seed)
    dcoord = delays_q[layout.party_of_coord(d)]
    own = _ownership(layout, d, dev, x.dtype)
    w = torch.zeros(d, dtype=x.dtype, device=dev)
    mask = torch.as_tensor(layout.update_mask(d, active_only),
                           device=dev).to(x.dtype)
    buf = torch.zeros((tau + 1, d), dtype=x.dtype, device=dev)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    if algo == "saga":
        tab, avg = saga_init(problem, w, x, y)
    fn = globals()[("faulted" if guard is None else "guarded")
                   + f"_{algo}_epoch"]
    health = []
    for ep in range(epochs):
        idx = epoch_indices(seed, ep, n, batch, steps, dev)
        win = sched.epoch(ep, steps)
        fc, bc, ec = win.coord_rows(layout, d)
        if algo == "svrg":
            head = (w, w, full_gradient(problem, w, x, y))
        else:
            head = (w, tab, avg) if algo == "saga" else (w,)
        common = (buf, t, x, y, lr, mask, dcoord)
        if guard is None:
            out = fn(problem, *head, *common, idx, fc, bc, ec)
        else:
            out = fn(problem, *head, *common, own, idx, win.fwd, bc, ec,
                     win.codes(), guard=guard)
            health.append(out[-1])
            out = out[:-1]
        if algo == "saga":
            w, tab, avg, buf, t = out
        else:
            w, buf, t = out
    w = w.cpu().numpy()
    return w if guard is None else (w, HealthStats.concat(health))


def run_faulted_reference(problem: Problem, x, y, layout: PartyLayout,
                          trace, tau: int, epochs: int, lr: float,
                          batch: int, algo: str = "sgd", seed: int = 0,
                          delays_q=None, active_only: bool = False,
                          device="cuda") -> np.ndarray:
    """The faulted oracles' driver on ``device`` (default the card; raises
    without one), in x's floating dtype: epoch ``ep`` runs the schedule
    ``epoch_indices(seed, ep, n, batch, n // batch)`` and the trace's
    window, SVRG's μ̃ and SAGA's table are full-membership rounds at w.
    Returns the final (d,) iterate."""
    return _oracle_run(problem, x, y, layout, trace, tau, epochs, lr, batch,
                       algo, seed, delays_q, active_only, device, None)


def run_guarded_reference(problem: Problem, x, y, layout: PartyLayout,
                          trace, tau: int, epochs: int, lr: float,
                          batch: int, algo: str = "sgd", seed: int = 0,
                          delays_q=None, active_only: bool = False,
                          guard: bool = True, device="cuda"):
    """The guarded oracles' driver (as :func:`run_faulted_reference`).
    Returns ``(w, HealthStats)``, the telemetry numpy (q, epochs·steps)."""
    return _oracle_run(problem, x, y, layout, trace, tau, epochs, lr, batch,
                       algo, seed, delays_q, active_only, device, guard)


def _fused_run(problem, x, y, layout, trace, tau, epochs, lr, batch, algo,
               seed, delays_q, engine_config, active_only, mesh,
               checkpoint_dir, resume_from, keep_last, horizon_epochs,
               device, guard):
    """The fused runners' shared loop; ``guard`` None runs the faulted
    epochs.  The state — iterate, ring, counter (SAGA's table and
    average, the guarded telemetry so far) — is checkpointed after every
    epoch."""
    from repro_torch.checkpoint import ckpt  # looked up at call time
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    if algo not in ("sgd", "svrg", "saga"):
        raise ValueError(f"unknown algo {algo}")
    n, d = np.shape(x)
    sched, delays_q, steps = _setup(trace, layout, n, batch, epochs,
                                    horizon_epochs, tau, delays_q, seed)
    horizon = sched.fwd.shape[0] // steps
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, active_only=active_only,
                      mesh=mesh, device=device)
    eng._local_only("the faulted and guarded runners")
    dev = eng.device
    dq = torch.from_numpy(delays_q).to(dev).long()
    st = {"wq": eng.pack_w(np.zeros(d, np.float32)),
          "bufq": torch.zeros((layout.q, tau + 1, eng.dp), device=dev),
          "t0": torch.zeros((), dtype=torch.int64, device=dev)}
    if algo == "saga":
        st["tabq"], st["avgq"] = eng.saga_init(st["wq"], (seed,))
    if guard is not None:
        st["health"] = HealthStats(*(np.zeros((layout.q, horizon * steps),
                                              np.float32) for _ in range(4)))
    ep0 = 0
    if resume_from is not None:
        loaded = ckpt.load_checkpoint(resume_from, st)
        ep0 = ckpt.checkpoint_step(resume_from)
        st = {k: (HealthStats(*v) if k == "health"
                  else torch.from_numpy(v).to(dev)) for k, v in loaded.items()}
    kind = "faulted" if guard is None else "guarded"
    for ep in range(ep0, epochs):
        win = sched.epoch(ep, steps)
        rows = [torch.from_numpy(a).to(dev) for a in win.party_rows()]
        kw = {}
        if guard is not None:
            rows.append(torch.from_numpy(win.corrupt_rows()).to(dev))
            kw["guard"] = guard
        idx = epoch_indices(seed, ep, n, batch, steps, dev)
        key = (seed, ep)
        tail = (st["bufq"], st["t0"], dq, *rows, lr, idx, tau, key)
        fn = getattr(eng, f"{kind}_{algo}_epoch")
        if algo == "sgd":
            out = fn(st["wq"], *tail, **kw)
            names = ("wq", "bufq", "t0")
        elif algo == "svrg":
            out = fn(st["wq"], st["wq"], eng.full_gradient(st["wq"], key),
                     *tail, **kw)
            names = ("wq", "bufq", "t0")
        else:
            out = fn(st["wq"], st["tabq"], st["avgq"], *tail, **kw)
            names = ("wq", "tabq", "avgq", "bufq", "t0")
        st.update(zip(names, out))
        if guard is not None:
            sl = slice(ep * steps, (ep + 1) * steps)
            for dst, src in zip(st["health"], out[-1]):
                dst[:, sl] = _host(src)
        if checkpoint_dir is not None:
            ckpt.save_checkpoint(checkpoint_dir, st, step=ep + 1,
                                 keep_last=keep_last)
    w = eng.unpack_w(st["wq"])
    return w if guard is None else (w, st["health"])


def run_faulted_fused(problem: Problem, x, y, layout: PartyLayout, trace,
                      tau: int, epochs: int, lr: float, batch: int,
                      algo: str = "sgd", seed: int = 0, delays_q=None,
                      engine_config=None, active_only: bool = False,
                      mesh=None, checkpoint_dir: Optional[str] = None,
                      resume_from: Optional[str] = None,
                      keep_last: Optional[int] = 1,
                      horizon_epochs: Optional[int] = None,
                      device="cuda") -> np.ndarray:
    """Faulted VFB² on the fused engine, on ``device`` (default the card;
    raises without one): the membership-masked epochs (survivor-aware
    secure aggregation, fault-gated rings) on the same start, schedules
    and delays as :func:`run_faulted_reference`, masks seeded from
    ``(seed, ep)``.  The trace spans ``horizon_epochs`` (default
    ``epochs``) epochs.

    ``checkpoint_dir=`` atomically checkpoints the state (iterate, ring,
    counter; SAGA's table and average) after every epoch, keeping the
    newest ``keep_last``; ``resume_from=`` restores it and continues — a
    killed run resumes from the last epoch boundary bit for bit, since
    each epoch is a function of that state and ``(seed, ep)``.  ``mesh=``
    (a ``PartyMesh`` on this one device) routes the survivor aggregation
    through the two-level membership form.  Returns the final (d,)
    iterate."""
    return _fused_run(problem, x, y, layout, trace, tau, epochs, lr, batch,
                      algo, seed, delays_q, engine_config, active_only, mesh,
                      checkpoint_dir, resume_from, keep_last, horizon_epochs,
                      device, None)


def run_guarded_fused(problem: Problem, x, y, layout: PartyLayout, trace,
                      tau: int, epochs: int, lr: float, batch: int,
                      algo: str = "sgd", seed: int = 0, delays_q=None,
                      engine_config=None, active_only: bool = False,
                      guard: bool = True, mesh=None,
                      checkpoint_dir: Optional[str] = None,
                      resume_from: Optional[str] = None,
                      keep_last: Optional[int] = 1,
                      horizon_epochs: Optional[int] = None, device="cuda"):
    """Guarded VFB² on the fused engine: corrupt-value injection, the
    health telemetry and (``guard=True``) the non-finite quarantine ride
    the captured steps.  As :func:`run_faulted_fused`; the checkpoints
    carry the telemetry so far, so a resumed run's health history is bit
    for bit the uninterrupted one's.  Returns ``(w, HealthStats)``, the
    telemetry numpy (q, horizon·steps)."""
    return _fused_run(problem, x, y, layout, trace, tau, epochs, lr, batch,
                      algo, seed, delays_q, engine_config, active_only, mesh,
                      checkpoint_dir, resume_from, keep_last, horizon_epochs,
                      device, guard)


# ---------------------------------------------------------------------------
# deep oracles (party loops)
# ---------------------------------------------------------------------------
#
# The deep delayed oracle's ring (``staleness._deep_ring_apply``) with the
# linear oracles' channels, per party: the survivor sum of the (B, d_rep)
# vector partials under the forward liveness (guarded: after the corrupt
# code and the quarantine of ``_guard_partials``), the ring write and the
# encoder update gated by the backward liveness, the read at
# max(t − (d + e), 0) mod (τ+1); the dominator-held head applies its
# gradient fresh.  ``pt`` is the parameter tuple (w1s, b1s, w2s, head) of
# per-party tuples, the rings per leaf, per party (τ+1, ...); ``blocks``
# the per-party (n, d_ℓ) feature blocks; the channels (steps, q) in party
# space.  Everything runs in the parameters' dtype (float64 included).

def _deep_ring_init(pt, tau: int):
    """Zeroed per-party encoder gradient rings: per leaf (w1, b1, w2) a
    (τ+1, ...) ring per party."""
    return tuple(tuple(torch.zeros((tau + 1,) + tuple(a.shape), dtype=a.dtype,
                                   device=a.device) for a in leaf)
                 for leaf in pt[:3])


def _survivor_sum(zp, live):
    """Σ_ℓ live_ℓ · zp[..., ℓ] over the party axis (last), in party order
    (the reference's left fold)."""
    out = live[0] * zp[..., 0]
    for p in range(1, zp.shape[-1]):
        out = out + live[p] * zp[..., p]
    return out


def _leaf_norm(*gs):
    """max |·| across one party's update-direction leaves (telemetry)."""
    return torch.stack([g.abs().amax() for g in gs]).amax()


def _deep_fault_step(problem, xb, yb, pt, rings, t, lr, de, f, bw,
                     snap=None, mu=None, c=None, guard: bool = True):
    """One sequential deep faulted (``c`` None) or guarded step on the
    blocks' rows ``xb``: ``de`` (q,) the step's delay + straggle, ``f``/
    ``bw`` (q,) forward and backward liveness, ``c`` (q,) corrupt codes.
    SVRG (``snap`` and its full gradient ``mu``): a party's message is
    both vector partials, and v = g(w) − g(w̃) + μ̃ enters the ring.
    Returns ``(pt, rings, health column (4, q) or None)``."""
    q = len(pt[0])
    sides = (pt,) if snap is None else (pt, snap)
    hs = [tuple(torch.tanh(xb[p] @ s[0][p] + s[1][p]) for p in range(q))
          for s in sides]
    zcols = [torch.stack([h[p] @ s[2][p] for p in range(q)], -1)
             for h, s in zip(hs, sides)]                 # (B, d_rep, q)
    if c is None:
        zs, live = zcols, f
    else:
        zs, zc, healthy, live = _guard_partials(zcols, f, c, guard)
    z = [_survivor_sum(a, live) for a in zs]
    grads = _bum_stale_grads(pt, xb, hs[0], z[0], yb, problem, q)
    if snap is not None:
        grads = _combine(grads, _bum_stale_grads(snap, xb, hs[1], z[1], yb,
                                                 problem, q), mu, 1)
    pt, rings = _deep_ring_apply(pt, rings, t, grads, lr, de, [1.0] * q,
                                 gate=bw)
    if c is None:
        return pt, rings, None
    pnorm = torch.stack([a.abs().flatten(0, -2).amax(0) for a in zc]) \
        .amax(0)
    gnorm = torch.stack([_leaf_norm(*(leaf[p] for leaf in grads[:3]))
                         for p in range(q)])
    return pt, rings, torch.stack([healthy, live, pnorm, gnorm])


def _deep_fault_epoch(problem, pt, snap, mu, rings, t0, blocks, y, lr,
                      delays, idx, fwd, bwd, extra, corrupt, guard):
    dev = pt[3].device
    delays, fwd, bwd, extra, *codes = _channels(
        pt[3], delays, (fwd, False), (bwd, False), (extra, True),
        *(() if corrupt is None else ((corrupt, True),)))
    codes = codes[0] if codes else None
    idx = torch.as_tensor(idx, device=dev).long()
    t = _t(t0, dev)
    hs = []
    for i in range(idx.shape[0]):
        ib = idx[i]
        pt, rings, col = _deep_fault_step(
            problem, [b[ib] for b in blocks], y[ib], pt, rings, t, lr,
            delays + extra[i], fwd[i], bwd[i], snap, mu,
            None if codes is None else codes[i], guard)
        if col is not None:
            hs.append(col)
        t = t + 1
    return (pt, rings, t) if corrupt is None else (pt, rings, t, _stats(hs))


def deep_faulted_sgd_epoch(problem: Problem, pt, rings, t0, blocks, y, lr,
                           delays, idx, fwd, bwd, extra):
    """One deep faulted VFB²-SGD epoch (the sequential oracle) over the
    (steps, B) schedule ``idx``: ``delays`` (q,) base delays, ``fwd``/
    ``bwd``/``extra`` (steps, q) forward and backward liveness and
    straggle's delay.  Returns ``(pt, rings, t)``."""
    return _deep_fault_epoch(problem, pt, None, None, rings, t0, blocks, y,
                             lr, delays, idx, fwd, bwd, extra, None, True)


def deep_faulted_svrg_epoch(problem: Problem, pt, snap, mu, rings, t0,
                            blocks, y, lr, delays, idx, fwd, bwd, extra):
    """Deep faulted VFB²-SVRG inner loop from the snapshot ``snap`` and
    its full-membership full gradient ``mu`` (both parameter tuples)."""
    return _deep_fault_epoch(problem, pt, snap, mu, rings, t0, blocks, y,
                             lr, delays, idx, fwd, bwd, extra, None, True)


def deep_guarded_sgd_epoch(problem: Problem, pt, rings, t0, blocks, y, lr,
                           delays, idx, fwd, bwd, extra, corrupt,
                           guard: bool = True):
    """One deep guarded VFB²-SGD epoch: the corrupt codes ``corrupt``
    (steps, q) rewrite each party's (B, d_rep) partial before the survivor
    sum; ``guard=True`` quarantines a non-finite one.  Returns ``(pt,
    rings, t, HealthStats)``, the telemetry (q, steps) tensors: gnorm is
    max |·| over the party's w1, b1 and w2 directions."""
    return _deep_fault_epoch(problem, pt, None, None, rings, t0, blocks, y,
                             lr, delays, idx, fwd, bwd, extra, corrupt,
                             guard)


def deep_guarded_svrg_epoch(problem: Problem, pt, snap, mu, rings, t0,
                            blocks, y, lr, delays, idx, fwd, bwd, extra,
                            corrupt, guard: bool = True):
    """Deep guarded VFB²-SVRG inner loop: one code corrupts both partials
    (iterate and snapshot) and the verdict covers both."""
    return _deep_fault_epoch(problem, pt, snap, mu, rings, t0, blocks, y,
                             lr, delays, idx, fwd, bwd, extra, corrupt,
                             guard)


def _deep_check(algo: str, guard):
    if algo not in ("sgd", "svrg"):
        kind = "faulted" if guard is None else "guarded"
        raise ValueError(f"deep {kind} VFB² supports sgd/svrg; got {algo}")


def _deep_oracle_run(problem, x, y, layout, trace, tau, epochs, lr, batch,
                     algo, seed, hidden, d_rep, delays_q, params, indices,
                     device, guard):
    """The deep oracle drivers' shared loop; ``guard`` None runs the
    faulted oracles."""
    _deep_check(algo, guard)
    dev, blocks, yt, pt = _deep_setup(x, y, layout, params, seed, hidden,
                                      d_rep, device)
    n = yt.shape[0]
    sched, delays_q, steps = _setup(trace, layout, n, batch, epochs, None,
                                    tau, delays_q, seed)
    rings = _deep_ring_init(pt, tau)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    health = []
    for ep, idx in enumerate(_schedules(indices, seed, epochs, n, batch,
                                        steps, dev)):
        win = sched.epoch(ep, steps)
        head = (pt,)
        if algo == "svrg":
            head = (pt, pt, _bum_grads(pt, list(blocks), yt, problem,
                                       layout.q))
        rows = (win.fwd, win.bwd, win.extra)
        common = (rings, t, blocks, yt, lr, delays_q, idx) + rows
        fn = globals()[("deep_faulted" if guard is None else "deep_guarded")
                       + f"_{algo}_epoch"]
        if guard is None:
            pt, rings, t = fn(problem, *head, *common)
        else:
            pt, rings, t, hs = fn(problem, *head, *common, win.codes(),
                                  guard=guard)
            health.append(hs)
    params = _to_params(pt)
    return params if guard is None else (params, HealthStats.concat(health))


def run_deep_faulted_reference(problem: Problem, x, y, layout: PartyLayout,
                               trace, tau: int, epochs: int, lr: float,
                               batch: int, algo: str = "sgd", seed: int = 0,
                               hidden: int = 32, d_rep: int = 16,
                               delays_q=None, params=None, indices=None,
                               device="cuda") -> DeepVFLParams:
    """The deep faulted oracles' driver on ``device`` (default the card;
    raises without one), in x's floating dtype, from ``params`` (default
    ``deep_vfl.initial_params(seed)``): epoch ``ep`` runs ``indices[ep]``
    (default ``epoch_indices(seed, ep, n, batch, n // batch)``) and the
    trace's window; SVRG's snapshot and μ̃ are full-membership rounds at
    the epoch's start.  Returns the final ``DeepVFLParams``."""
    return _deep_oracle_run(problem, x, y, layout, trace, tau, epochs, lr,
                            batch, algo, seed, hidden, d_rep, delays_q,
                            params, indices, device, None)


def run_deep_guarded_reference(problem: Problem, x, y, layout: PartyLayout,
                               trace, tau: int, epochs: int, lr: float,
                               batch: int, algo: str = "sgd", seed: int = 0,
                               hidden: int = 32, d_rep: int = 16,
                               delays_q=None, guard: bool = True,
                               params=None, indices=None, device="cuda"):
    """The deep guarded oracles' driver (as
    :func:`run_deep_faulted_reference`).  Returns ``(DeepVFLParams,
    HealthStats)``, the telemetry numpy (q, epochs·steps)."""
    return _deep_oracle_run(problem, x, y, layout, trace, tau, epochs, lr,
                            batch, algo, seed, hidden, d_rep, delays_q,
                            params, indices, device, guard)


def _deep_fused_run(problem, x, y, layout, trace, tau, epochs, lr, batch,
                    algo, seed, hidden, d_rep, delays_q, engine_config,
                    checkpoint_dir, resume_from, keep_last, horizon_epochs,
                    device, guard):
    """The deep fused runners' shared loop; ``guard`` None runs the
    faulted epochs.  The state — packed params, the per-party encoder
    rings in the reference's per-leaf layout, the counter (the guarded
    telemetry so far) — is checkpointed after every epoch."""
    from repro_torch.checkpoint import ckpt  # looked up at call time
    from repro_torch.core.deep_vfl import initial_params
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    _deep_check(algo, guard)
    n, d = np.shape(x)
    sched, delays_q, steps = _setup(trace, layout, n, batch, epochs,
                                    horizon_epochs, tau, delays_q, seed)
    horizon = sched.fwd.shape[0] // steps
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, device=device)
    dev = eng.device
    dq = torch.from_numpy(delays_q).to(dev).long()
    pq = eng.pack_deep(initial_params(seed, layout, d, hidden, d_rep))
    st = {"pq": pq, "bufq": eng.deep_delay_buffers(pq, tau),
          "t0": torch.zeros((), dtype=torch.int64, device=dev)}
    if guard is not None:
        st["health"] = HealthStats(*(np.zeros((layout.q, horizon * steps),
                                              np.float32) for _ in range(4)))
    ep0 = 0
    if resume_from is not None:
        loaded = ckpt.load_checkpoint(resume_from, st)
        ep0 = ckpt.checkpoint_step(resume_from)
        st = {k: (HealthStats(*v) if k == "health" else
                  tuple(torch.from_numpy(a).to(dev) for a in v)
                  if isinstance(v, tuple) else torch.from_numpy(v).to(dev))
              for k, v in loaded.items()}
    kind = "faulted" if guard is None else "guarded"
    fn = getattr(eng, f"deep_{kind}_{algo}_epoch")
    for ep in range(ep0, epochs):
        win = sched.epoch(ep, steps)
        rows = [torch.from_numpy(a).to(dev) for a in win.party_rows()]
        kw = {}
        if guard is not None:
            rows.append(torch.from_numpy(win.corrupt_rows()).to(dev))
            kw["guard"] = guard
        idx = epoch_indices(seed, ep, n, batch, steps, dev)
        key = (seed, ep)
        head = (st["pq"],)
        if algo == "svrg":
            head = (st["pq"], st["pq"], eng.deep_full_gradient(st["pq"], key))
        out = fn(*head, st["bufq"], st["t0"], dq, *rows, lr, idx, tau, key,
                 **kw)
        st.update(zip(("pq", "bufq", "t0"), out))
        if guard is not None:
            sl = slice(ep * steps, (ep + 1) * steps)
            for dst, src in zip(st["health"], out[-1]):
                dst[:, sl] = _host(src)
        if checkpoint_dir is not None:
            ckpt.save_checkpoint(checkpoint_dir, st, step=ep + 1,
                                 keep_last=keep_last)
    params = eng.unpack_deep(st["pq"])
    return params if guard is None else (params, st["health"])


def run_deep_faulted_fused(problem: Problem, x, y, layout: PartyLayout,
                           trace, tau: int, epochs: int, lr: float,
                           batch: int, algo: str = "sgd", seed: int = 0,
                           hidden: int = 32, d_rep: int = 16, delays_q=None,
                           engine_config=None,
                           checkpoint_dir: Optional[str] = None,
                           resume_from: Optional[str] = None,
                           keep_last: Optional[int] = 1,
                           horizon_epochs: Optional[int] = None,
                           device="cuda") -> DeepVFLParams:
    """Deep faulted VFB² on the fused engine, on ``device`` (default the
    card; raises without one): the deep faulted epochs (each an eager
    step and replays of one CUDA graph on the card) from
    ``deep_vfl.initial_params(seed)`` on the schedules, delays and trace
    windows of :func:`run_deep_faulted_reference`, masks seeded from
    ``(seed, ep)``; SVRG's μ̃ is ``deep_full_gradient`` at each epoch's
    start.  ``checkpoint_dir=``, ``resume_from=``, ``keep_last=`` and
    ``horizon_epochs=`` as in :func:`run_faulted_fused`: the bundle holds
    the packed params, the encoder rings (per leaf, (q, τ+1, ...)) and the
    counter, and a killed run resumes bit for bit.  Returns the final
    ``DeepVFLParams``."""
    return _deep_fused_run(problem, x, y, layout, trace, tau, epochs, lr,
                           batch, algo, seed, hidden, d_rep, delays_q,
                           engine_config, checkpoint_dir, resume_from,
                           keep_last, horizon_epochs, device, None)


def run_deep_guarded_fused(problem: Problem, x, y, layout: PartyLayout,
                           trace, tau: int, epochs: int, lr: float,
                           batch: int, algo: str = "sgd", seed: int = 0,
                           hidden: int = 32, d_rep: int = 16, delays_q=None,
                           engine_config=None, guard: bool = True,
                           checkpoint_dir: Optional[str] = None,
                           resume_from: Optional[str] = None,
                           keep_last: Optional[int] = 1,
                           horizon_epochs: Optional[int] = None,
                           device="cuda"):
    """Deep guarded VFB² on the fused engine (as
    :func:`run_deep_faulted_fused`); the checkpoints carry the telemetry
    so far.  Returns ``(DeepVFLParams, HealthStats)``, the telemetry numpy
    (q, horizon·steps)."""
    return _deep_fused_run(problem, x, y, layout, trace, tau, epochs, lr,
                           batch, algo, seed, hidden, d_rep, delays_q,
                           engine_config, checkpoint_dir, resume_from,
                           keep_last, horizon_epochs, device, guard)
