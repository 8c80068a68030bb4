"""Bounded-delay (τ) emulation of BAPA: the stale-gradient linear and
deep epochs.

The port of ``repro.core.staleness``.  The paper's
asynchronous iterate sequence (Eqs. 4–5) is realised deterministically:
party ℓ applies, at global step t, the BUM gradient computed from the
iterate of step t − d_ℓ, with per-party delays d_ℓ ≤ τ.  The state is a
ring of the last τ+1 gradients; early steps read slot max(t − d, 0), the
first step's gradient.  Every active party is the dominator of its own
block, so all m active-party delays are zero.

Multi-dominator: party ℓ receives m update streams, one per dominator,
each aging under its own delay d_{ℓ,j} (a (q, m) matrix with d_{j,j} = 0):
dominator j's gradient column, regulariser of its own step's iterate
included, enters ring column j, and the applied update sums the m stale
columns.

Pipelined: the gradient entering the ring is already a τ = 1 stale-read
one (ϑ from the forward read taken before the previous update), which
composes with the delay schedule to a total delay of τ + 1.

* The oracles (``delayed_sgd_epoch``, ``pipelined_delayed_sgd_epoch``,
  ``delayed_multi_sgd_epoch``, ``pipelined_delayed_multi_sgd_epoch``)
  are plain torch on the pooled (n, d) data with the per-coordinate delay
  form, (d,) or (d, m), dtype-generic, and take an explicit
  ``(steps, batch)`` (``(steps, m·batch)``) int64 schedule ``idx``
  where the reference draws one from its key.
* The delay schedules are numpy and give the reference's integers for the
  same seed.
* The runners ``run_delayed_fused`` and ``run_delayed_multi_fused`` run
  ``core.engine.FusedEngine``'s delayed epochs (each a CUDA-graph replay
  of its step on the card), carrying the ring and the global step from
  one epoch to the next.

Deep: each party's encoder gradients (w1, b1, w2, regulariser included)
age in its rings; the dominator-held head applies its gradient fresh,
since delaying a replicated parameter would fork the replicas.  In the
multi-dominator form each dominator's Jacobian-transpose slabs stay
apart (``deep_vfl._bum_dom_grads``, λ∇g once per stream) and age under
d_{ℓ,j}; the head takes the fresh summed gradient with m·λ∇g.

* The oracles ``train_deep_delayed`` and ``train_deep_multi_delayed``
  (both also ``pipelined=True``) are ``deep_vfl.train_deep_vfl``'s
  rounds with the rings: per-party loops, dtype-generic, ``params=`` and
  ``indices=`` as there (by default ``initial_params(seed)`` and
  ``epoch_indices(seed, ep, …)``), the delays of ``seed``.  They return
  the final params, the rings and the global step, and each epoch's
  objective.
* The runners ``run_deep_delayed_fused`` and
  ``run_deep_multi_delayed_fused`` run the engine's deep delayed epochs
  on the same start, schedules and delays, carrying the rings and the
  counter across epochs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import PartyLayout, _rounds, epoch_indices
from repro_torch.core.deep_vfl import (DeepVFLParams, _bum_dom_grads,
                                       _bum_stale_grads, _deep_fwd_acts,
                                       _objective, _schedules, _setup,
                                       _to_params, initial_params)
from repro_torch.core.losses import Problem


# ---------------------------------------------------------------------------
# delay schedules (numpy; the reference's integers for the same seed)
# ---------------------------------------------------------------------------

def party_delay_values(layout: PartyLayout, tau: int,
                       seed: int = 0) -> np.ndarray:
    """One delay in [0, τ] per party (the deterministic τ₁/τ₂ schedule);
    the m active parties' delays are zero (Alg. 2: a dominator's own block
    update uses its fresh gradient).  (q,) int32."""
    rng = np.random.default_rng(seed)
    per_party = rng.integers(0, tau + 1, size=layout.q)
    per_party[:layout.m] = 0
    return per_party.astype(np.int32)


def party_delays(layout: PartyLayout, d: int, tau: int,
                 seed: int = 0) -> np.ndarray:
    """The per-party delays mapped to coordinates: (d,) int32."""
    per_party = party_delay_values(layout, tau, seed)
    return per_party[layout.party_of_coord(d)].astype(np.int32)


def party_dominator_delays(layout: PartyLayout, tau: int,
                           seed: int = 0) -> np.ndarray:
    """(q, m) int32 delays d_{ℓ,j}: party ℓ's staleness for dominator j's
    update stream; the diagonal d_{j,j} is zero."""
    rng = np.random.default_rng(seed)
    dd = rng.integers(0, tau + 1, size=(layout.q, layout.m))
    for j in range(layout.m):
        dd[j, j] = 0
    return dd.astype(np.int32)


def dominator_delays_by_coord(layout: PartyLayout, d: int, tau: int,
                              seed: int = 0) -> np.ndarray:
    """The (q, m) schedule mapped to coordinates: (d, m) int32."""
    dd = party_dominator_delays(layout, tau, seed)
    return dd[layout.party_of_coord(d)].astype(np.int32)


# ---------------------------------------------------------------------------
# oracle state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DelayedState:
    w: torch.Tensor          # (d,)
    buf: torch.Tensor        # (τ+1, d) gradient ring
    t: torch.Tensor          # 0-d int64 global step


@dataclasses.dataclass
class MultiDelayedState:
    w: torch.Tensor          # (d,)
    buf: torch.Tensor        # (τ+1, d, m) per-dominator gradient ring
    t: torch.Tensor          # 0-d int64 global step


def init_state(d: int, tau: int, *, dtype=torch.float32,
               device="cuda") -> DelayedState:
    dev = resolve_device(device)
    return DelayedState(w=torch.zeros(d, dtype=dtype, device=dev),
                        buf=torch.zeros((tau + 1, d), dtype=dtype,
                                        device=dev),
                        t=torch.zeros((), dtype=torch.int64, device=dev))


def init_multi_state(d: int, tau: int, m: int, *, dtype=torch.float32,
                     device="cuda") -> MultiDelayedState:
    dev = resolve_device(device)
    return MultiDelayedState(w=torch.zeros(d, dtype=dtype, device=dev),
                             buf=torch.zeros((tau + 1, d, m), dtype=dtype,
                                             device=dev),
                             t=torch.zeros((), dtype=torch.int64,
                                           device=dev))


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def _delayed_round(problem: Problem, x, y, lr, mask, delays, m: int):
    """One stale step on the state ``(w, buf, t)`` from the forward read
    ``z`` of the round's rows: the m dominators' gradients (each
    Xᵀϑ_j/B + λ∇g(w)) enter ring slot t, and the update applies slot
    max(t − d, 0) of each coordinate (of each (coordinate, dominator)
    pair, summed over the dominators).  ``m = 1`` with (d,) delays is the
    single-dominator form."""
    multi = delays.dim() == 2

    def step(state, z, ib):
        w, buf, t = state
        theta = problem.theta(z, y[ib])
        b = ib.shape[0] // m
        g = (x[ib].view(m, b, -1).transpose(1, 2) @ theta.view(m, b, 1)) \
            .squeeze(-1).T / b + problem.lam * problem.reg_grad(w)[:, None]
        if not multi:
            g = g[:, 0]
        ring = buf.shape[0]
        buf = buf.index_copy(0, (t % ring).view(1), g[None])
        eff = (t - delays).clamp_min(0) % ring
        stale = buf.gather(0, eff[None]).squeeze(0)
        if multi:
            stale = stale.sum(1)
        return w - lr * mask * stale, buf, t + 1

    return step


def _delayed_epoch(problem, state, x, y, lr, delays, idx, m, mask,
                   pipelined):
    upd = torch.ones_like(state.w) if mask is None else mask
    delays = torch.as_tensor(delays, device=state.w.device).long()
    w, buf, t = _rounds(_delayed_round(problem, x, y, lr, upd, delays, m),
                        (state.w, state.buf, state.t),
                        lambda st, ib: x[ib] @ st[0], idx, pipelined)
    return type(state)(w=w, buf=buf, t=t)


def delayed_sgd_epoch(problem: Problem, state: DelayedState, x, y, lr,
                      delays, idx, mask=None) -> DelayedState:
    """One epoch of stale-gradient VFB²-SGD over the (steps, B) schedule
    ``idx``.  ``delays``: (d,) per-coordinate delays (constant per party
    block); ``mask``: optional (d,) update mask — frozen blocks stay
    frozen on the delayed path too."""
    return _delayed_epoch(problem, state, x, y, lr, delays, idx, 1, mask,
                          False)


def pipelined_delayed_sgd_epoch(problem: Problem, state: DelayedState, x,
                                y, lr, delays, idx,
                                mask=None) -> DelayedState:
    """The pipelined stale-gradient epoch: step t's gradient comes from
    the τ = 1 stale forward read (the epoch's first read is fresh), then
    ages in the ring as in :func:`delayed_sgd_epoch`."""
    return _delayed_epoch(problem, state, x, y, lr, delays, idx, 1, mask,
                          True)


def delayed_multi_sgd_epoch(problem: Problem, state: MultiDelayedState, x,
                            y, lr, delays, idx, m: int,
                            mask=None) -> MultiDelayedState:
    """Multi-dominator stale-gradient VFB²-SGD over the (steps, m·B)
    schedule ``idx``: the m dominators compute their gradients from the
    same read w_t; gradient j enters ring column j; the update sums, per
    coordinate, each dominator's gradient from step t − d_{·,j}.
    ``delays``: (d, m)."""
    return _delayed_epoch(problem, state, x, y, lr, delays, idx, m, mask,
                          False)


def pipelined_delayed_multi_sgd_epoch(problem: Problem,
                                      state: MultiDelayedState, x, y, lr,
                                      delays, idx, m: int,
                                      mask=None) -> MultiDelayedState:
    """Pipelined multi-dominator stale-gradient epoch: the m ϑ vectors of
    step t come from the τ = 1 stale forward read, then each column ages
    in its ring column as in :func:`delayed_multi_sgd_epoch`."""
    return _delayed_epoch(problem, state, x, y, lr, delays, idx, m, mask,
                          True)


# ---------------------------------------------------------------------------
# deep oracles: each party's encoder gradients age, the head stays fresh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeepDelayedState:
    params: DeepVFLParams
    rings: tuple             # per leaf (w1, b1, w2), per party (τ+1[, m], ...)
    t: torch.Tensor          # 0-d int64 global step


def _deep_ring_apply(pt, rings, t, grads, lr, delays, live, m: int = 1,
                     multi: bool = False, gate=None):
    """Age the encoder gradients ``grads`` through the per-party rings:
    they enter slot t mod (τ+1) of every party, party ℓ's update reads
    slot max(t − d_ℓ, 0) (under ``multi`` dominator j's slab at
    max(t − d_{ℓ,j}, 0), the m slabs summed) and applies it scaled by
    ``live[ℓ]``; the head applies its gradient fresh.  ``gate`` (q,),
    where given, keeps party ℓ's ring and encoder as they were where
    gate[ℓ] = 0 (the fault oracles' backward liveness: no write, no
    update).  Returns ``(pt, rings)``."""
    slots = rings[0][0].shape[0]
    new_pt, new_rings = [], []
    for leaves, ring, g in zip(pt[:3], rings, grads[:3]):
        ps, rs = [], []
        for p in range(len(leaves)):
            buf = ring[p].index_copy(0, (t % slots).view(1), g[p][None])
            if gate is not None:
                buf = torch.where(gate[p] > 0, buf, ring[p])
            eff = (t - delays[p]).clamp_min(0) % slots
            # a 0-d index tensor would be read on the host: index_select
            stale = buf[eff, torch.arange(m, device=eff.device)].sum(0) \
                if multi else buf.index_select(0, eff.view(1))[0]
            upd = leaves[p] - lr * live[p] * stale
            ps.append(upd if gate is None
                      else torch.where(gate[p] > 0, upd, leaves[p]))
            rs.append(buf)
        new_pt.append(tuple(ps))
        new_rings.append(tuple(rs))
    return tuple(new_pt) + (pt[3] - lr * grads[3],), tuple(new_rings)


def _deep_ring_round(problem, blocks, y, lr, delays, live, q: int, m: int,
                     multi: bool):
    """One stale deep step on the state ``(pt, rings, t)`` from the
    activations ``acts`` of the round's rows: the BUM gradients (each
    dominator's apart under ``multi``, λ∇g once per stream) age through
    the rings (:func:`_deep_ring_apply`)."""
    def step(state, acts, ib):
        pt, rings, t = state
        hs, z = acts
        xb = [b[ib] for b in blocks]
        if multi:
            grads = _bum_dom_grads(pt, xb, hs, z, y[ib], problem, q, m)
        else:
            grads = _bum_stale_grads(pt, xb, hs, z, y[ib], problem, q)
        return _deep_ring_apply(pt, rings, t, grads, lr, delays, live, m,
                                multi) + (t + 1,)

    return step


def _train_deep_delayed(problem, x, y, layout, tau, epochs, lr, batch, seed,
                        hidden, d_rep, freeze_passive, pipelined, params,
                        indices, device, multi):
    dev, blocks, yt, pt = _setup(x, y, layout, params, seed, hidden, d_rep,
                                 device)
    n = yt.shape[0]
    q, m = layout.q, layout.m
    delays = torch.from_numpy(
        party_dominator_delays(layout, tau, seed) if multi
        else party_delay_values(layout, tau, seed)).to(dev).long()
    live = [0.0 if (freeze_passive and p >= m) else 1.0 for p in range(q)]
    lead = (tau + 1, m) if multi else (tau + 1,)
    rings = tuple(tuple(torch.zeros(lead + a.shape, dtype=a.dtype, device=dev)
                        for a in leaf) for leaf in pt[:3])
    state = (pt, rings, torch.zeros((), dtype=torch.int64, device=dev))
    step = _deep_ring_round(problem, blocks, yt, lr, delays, live, q, m,
                            multi)
    hist = []
    for idx in _schedules(indices, seed, epochs, n,
                          (m if multi else 1) * batch, max(1, n // batch),
                          dev):
        state = _rounds(step, state, lambda st, ib: _deep_fwd_acts(
            st[0], [b[ib] for b in blocks], q), idx, pipelined)
        hist.append(_objective(problem, _to_params(state[0]), blocks, yt))
    return DeepDelayedState(_to_params(state[0]), *state[1:]), hist


def train_deep_delayed(problem: Problem, x, y, layout: PartyLayout,
                       tau: int, epochs: int = 3, lr: float = 0.05,
                       batch: int = 32, seed: int = 0, hidden: int = 32,
                       d_rep: int = 16, freeze_passive: bool = False,
                       pipelined: bool = False, params=None, indices=None,
                       device="cuda"):
    """The sequential oracle of bounded-delay deep VFB²-SGD on ``device``
    (default the card; raises without one): ``deep_vfl.train_deep_vfl``'s
    rounds with per-party encoder gradient rings under the delays
    :func:`party_delay_values` of ``seed``; the head stays fresh.
    ``pipelined=True`` makes each ringed gradient a τ = 1 stale-read one.
    ``params`` and ``indices`` as in ``train_deep_vfl`` (by default
    ``initial_params(seed)`` and ``epoch_indices(seed, ep, n, batch,
    n // batch)``); it runs in x's floating dtype.  Returns
    ``(DeepDelayedState, objectives)``: the final params, the rings (per
    party (τ+1, ...) a leaf) and the global step, and each epoch's
    objective."""
    return _train_deep_delayed(problem, x, y, layout, tau, epochs, lr, batch,
                               seed, hidden, d_rep, freeze_passive,
                               pipelined, params, indices, device, False)


def train_deep_multi_delayed(problem: Problem, x, y, layout: PartyLayout,
                             tau: int, epochs: int = 3, lr: float = 0.05,
                             batch: int = 32, seed: int = 0,
                             hidden: int = 32, d_rep: int = 16,
                             freeze_passive: bool = False,
                             pipelined: bool = False, params=None,
                             indices=None, device="cuda"):
    """The sequential oracle of bounded-delay multi-dominator deep
    VFB²-SGD: m·batch rows a step; every party keeps one ring per
    dominator's stream (per party (τ+1, m, ...) a leaf) under the (q, m)
    delays :func:`party_dominator_delays` of ``seed`` (the diagonal
    fresh), and the head applies the fresh summed gradient.  Otherwise as
    :func:`train_deep_delayed`."""
    return _train_deep_delayed(problem, x, y, layout, tau, epochs, lr, batch,
                               seed, hidden, d_rep, freeze_passive,
                               pipelined, params, indices, device, True)


# ---------------------------------------------------------------------------
# runners (the fused engine's delayed epochs)
# ---------------------------------------------------------------------------

def _run_fused(problem, x, y, layout, tau, epochs, lr, batch, seed,
               engine_config, active_only, pipelined, device, multi):
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    n, d = x.shape
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, active_only=active_only,
                      device=device)
    delays = party_dominator_delays(layout, tau, seed) if multi \
        else party_delay_values(layout, tau, seed)
    delays = torch.from_numpy(delays).to(eng.device)
    wq = eng.pack_w(np.zeros(d, np.float32))
    bufq = torch.zeros((layout.q, tau + 1, eng.dp)
                       + ((layout.m,) if multi else ()),
                       dtype=torch.float32, device=eng.device)
    t0 = 0
    steps = max(1, n // batch)
    rows = layout.m * batch if multi else batch
    epoch = getattr(eng, ("multi_" if multi else "")
                    + ("pipelined_" if pipelined else "")
                    + "delayed_sgd_epoch")
    for ep in range(epochs):
        idx = epoch_indices(seed, ep, n, rows, steps, eng.device)
        wq, bufq, t0 = epoch(wq, bufq, t0, delays, lr, idx, tau, (seed, ep))
    return eng.unpack_w(wq)


def run_delayed_fused(problem: Problem, x, y, layout: PartyLayout,
                      tau: int, epochs: int, lr: float, batch: int,
                      seed: int = 0, engine_config=None,
                      active_only: bool = False, pipelined: bool = False,
                      device="cuda") -> np.ndarray:
    """Bounded-delay VFB²-SGD on the fused engine, on ``device`` (default
    the card; raises without one).  Epoch ``ep`` runs the schedule
    ``epoch_indices(seed, ep, n, batch, n // batch)`` with masks seeded
    from ``(seed, ep)``, as ``algorithms.train`` does, under the delays
    ``party_delay_values(layout, tau, seed)``; the ring and the global
    step carry across epochs.  ``active_only=True`` freezes the passive
    blocks; ``pipelined=True`` runs the pipelined delayed epoch.  Returns
    the final (d,) iterate."""
    return _run_fused(problem, x, y, layout, tau, epochs, lr, batch, seed,
                      engine_config, active_only, pipelined, device, False)


def run_delayed_multi_fused(problem: Problem, x, y, layout: PartyLayout,
                            tau: int, epochs: int, lr: float, batch: int,
                            seed: int = 0, engine_config=None,
                            active_only: bool = False,
                            pipelined: bool = False,
                            device="cuda") -> np.ndarray:
    """Multi-dominator bounded-delay VFB²-SGD on the fused engine: m·batch
    ids a step (``epoch_indices(seed, ep, n, m*batch, n // batch)``), each
    party carrying m gradient rings under the (q, m) delays
    ``party_dominator_delays(layout, tau, seed)``.  Otherwise as
    :func:`run_delayed_fused`.  Returns the final (d,) iterate."""
    return _run_fused(problem, x, y, layout, tau, epochs, lr, batch, seed,
                      engine_config, active_only, pipelined, device, True)


def _run_deep_fused(problem, x, y, layout, tau, epochs, lr, batch, seed,
                    hidden, d_rep, engine_config, active_only, pipelined,
                    device, multi):
    from repro_torch.core.engine import EngineConfig, FusedEngine  # cycle

    n, d = x.shape
    cfg = engine_config if engine_config is not None else EngineConfig()
    eng = FusedEngine(problem, x, y, layout, cfg, active_only=active_only,
                      device=device)
    pq = eng.pack_deep(initial_params(seed, layout, d, hidden, d_rep))
    delays = party_dominator_delays(layout, tau, seed) if multi \
        else party_delay_values(layout, tau, seed)
    delays = torch.from_numpy(delays).to(eng.device)
    bufq = (eng.deep_multi_delay_buffers if multi
            else eng.deep_delay_buffers)(pq, tau)
    t0 = 0
    steps = max(1, n // batch)
    rows = layout.m * batch if multi else batch
    epoch = getattr(eng, "deep_" + ("multi_" if multi else "")
                    + ("pipelined_" if pipelined else "")
                    + "delayed_sgd_epoch")
    for ep in range(epochs):
        idx = epoch_indices(seed, ep, n, rows, steps, eng.device)
        pq, bufq, t0 = epoch(pq, bufq, t0, delays, lr, idx, tau, (seed, ep))
    return eng.unpack_deep(pq)


def run_deep_delayed_fused(problem: Problem, x, y, layout: PartyLayout,
                           tau: int, epochs: int, lr: float, batch: int,
                           seed: int = 0, hidden: int = 32, d_rep: int = 16,
                           engine_config=None, active_only: bool = False,
                           pipelined: bool = False,
                           device="cuda") -> DeepVFLParams:
    """Bounded-delay deep VFB²-SGD on the fused engine, on ``device``
    (default the card; raises without one), from ``initial_params(seed)``:
    epoch ``ep`` runs ``epoch_indices(seed, ep, n, batch, n // batch)``
    with masks seeded from ``(seed, ep)`` under the delays
    ``party_delay_values(layout, tau, seed)``, the rings and the global
    step carried across epochs, as :func:`train_deep_delayed` does.
    ``pipelined=True`` runs the pipelined delayed epoch.  Returns the
    final ``DeepVFLParams``."""
    return _run_deep_fused(problem, x, y, layout, tau, epochs, lr, batch,
                           seed, hidden, d_rep, engine_config, active_only,
                           pipelined, device, False)


def run_deep_multi_delayed_fused(problem: Problem, x, y,
                                 layout: PartyLayout, tau: int, epochs: int,
                                 lr: float, batch: int, seed: int = 0,
                                 hidden: int = 32, d_rep: int = 16,
                                 engine_config=None,
                                 active_only: bool = False,
                                 pipelined: bool = False,
                                 device="cuda") -> DeepVFLParams:
    """Multi-dominator bounded-delay deep VFB²-SGD on the fused engine:
    m·batch ids a step, per-(party, dominator) rings under the (q, m)
    delays ``party_dominator_delays(layout, tau, seed)``.  Otherwise as
    :func:`run_deep_delayed_fused`."""
    return _run_deep_fused(problem, x, y, layout, tau, epochs, lr, batch,
                           seed, hidden, d_rep, engine_config, active_only,
                           pipelined, device, True)
