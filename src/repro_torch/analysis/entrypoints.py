"""The lintable entry-point matrix of the port.

The counterpart of ``repro.analysis.entrypoints``: small fixture engines
for every security mode, each shipped epoch entry point — linear and
deep, SGD/SVRG/SAGA, multi-dominator, pipelined, delayed, faulted and
guarded, serving, and the ``hier_*`` packings over a ``PartyMesh`` —
traced through ``FusedEngine.tracing`` (``party_program``) or the serving
probes, and the passes run over the traces:

* leakage taint (:mod:`repro_torch.analysis.taint`), with the engine's
  feature block as the source; faulted and guarded entries under
  ``membership=True`` (the membership rule), the guard's finiteness
  verdict declassified;
* ring-buffer staleness (:func:`~repro_torch.analysis.schedule.ring_audit`)
  on the τ-entries;
* the structural census: host transfers must be zero and party-axis
  boundaries present.

Everything traces over fake tensors — no epoch runs — so the whole matrix
lints in seconds.  The fixture is the reference's (``entrypoints.py``:
N, D, Q, M = 48, 12, 4, 2; batch 8; 3 steps; τ 2; hidden 4; d_rep 3),
its data drawn by numpy from seed 0.  An epoch's index schedule only
shapes the trace; ``indices`` (``(n, batch, steps) -> (steps, batch)``)
supplies it, by default ``core.algorithms.epoch_indices``.

On a device mesh (``PartyMesh(mesh=DeviceMesh)``, :mod:`repro_torch.
analysis.mesh`) a fixture's engine holds the rank's rows of the same
data, iterate, buffers, delays and fault channels (``FusedEngine.local``)
and every entry traces the rank's own program.  The entries run in three
worlds (``MESH_WORLDS``): ``flat``, Q ranks of one party each, the 19
entries without a packing; ``hier``, Q/2 ranks of 2 parties, the
``hier_*`` entries of ``HIER``; ``hier_ddp``, model Q/2 × data 2, the
``hier_sgd_ddp`` entry.  Every rank calls every entry in the same order
(the collectives of a fixture's serving weights and storage audit run
for real).

Device rule: ``analyze_matrix``, ``kernel_census`` and ``Fixture``
default to ``device="cuda"`` and raise without a card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.schedule import ring_audit
from repro_torch.analysis.taint import Analyzer, finding_codes
from repro_torch.analysis.walkers import (count_host_transfers,
                                          count_model_collectives,
                                          vfl_grad_census)
from repro_torch.core import deep_vfl, losses
from repro_torch.core.algorithms import PartyLayout, epoch_indices
from repro_torch.core.engine import EngineConfig, FusedEngine
from repro_torch.serve import ServeEngine
from repro_torch.sharding.api import PartyMesh

# fixture dimensions — the reference's
N, D, Q, M = 48, 12, 4, 2
BATCH, STEPS, TAU = 8, 3, 2
HIDDEN, DREP = 4, 3

#: the ``hier_*`` packings: the Q parties over Q // 2 slots, and the same
#: with the data axis (sliced minibatches, one mask draw per slice)
HIER = PartyMesh(q=Q, slots=Q // 2)
HIER_DDP = PartyMesh(q=Q, slots=Q // 2, data_shards=2)

#: security modes ("two_tree_sf": two_tree replaying the T1/T2 rounds)
SECURE_MODES = ("off", "two_tree", "ring", "two_tree_sf")

#: the device-mesh worlds: name -> (ranks, model size, the one-device
#: packing whose entries it runs); a rank's mesh is
#: ``make_device_mesh(model size, q=Q)``, data = ranks // model size
MESH_WORLDS = {"flat": (Q, Q, None), "hier": (Q // 2, Q // 2, HIER),
               "hier_ddp": (Q, Q // 2, HIER_DDP)}


def default_indices(n: int, batch: int, steps: int) -> torch.Tensor:
    """The CLI's schedule: epoch 0 of ``epoch_indices`` from seed 0."""
    return epoch_indices(0, 0, n, batch, steps)


@dataclasses.dataclass
class Entry:
    """One traceable entry point."""

    name: str                  # report name, e.g. "sgd", "hier_sgd"
    trace: Callable            # (eng, fixture) -> the traced program
    tau: Optional[int] = None  # ring audit expected iff set
    membership: bool = False   # taint under the membership rule
    gated: bool = False        # rings are liveness-gated (faulted epochs)
    pmesh: Optional[PartyMesh] = None   # hierarchical packing


@dataclasses.dataclass
class EntryReport:
    """The analysis of one entry under one security mode."""

    name: str
    secure: str
    taint: Dict[str, int]      # finding-code histogram (empty = clean)
    host_transfers: int
    cross_party: int           # party-axis boundaries in the program
    rings: List[dict]          # RingAudit.to_dict() per ring
    membership: bool
    gated: bool
    census: int = 0            # vfl_grad nodes a step
    unknown: List[str] = dataclasses.field(default_factory=list)
    collectives: Optional[int] = None  # model-group collectives (a rank)
    released: int = 0          # served answers broadcast (a rank)

    @property
    def key(self) -> str:
        return f"{self.secure}/{self.name}"


class Fixture:
    """The deterministic tiny dataset and one engine of a security mode."""

    def __init__(self, secure: str, device="cuda",
                 pmesh: Optional[PartyMesh] = None, indices=None):
        rng = np.random.default_rng(0)
        self.x = rng.standard_normal((N, D)).astype(np.float32)
        self.y = np.where(rng.standard_normal(N) > 0, 1.0, -1.0) \
            .astype(np.float32)
        self.layout = PartyLayout.even(D, Q, M)
        self.prob = losses.logistic_l2(1e-3)
        mode, sf = (("two_tree", True) if secure == "two_tree_sf"
                    else (secure, False))
        self.cfg = EngineConfig(secure=mode, schedule_faithful=sf)
        self.eng = FusedEngine(self.prob, self.x, self.y, self.layout,
                               self.cfg, mesh=pmesh, device=device)
        dev, mine = self.eng.device, self.eng.local
        indices = indices or default_indices
        self.idx = torch.as_tensor(np.array(indices(N, BATCH, STEPS)))
        self.idx_m = torch.as_tensor(np.array(indices(N, M * BATCH, STEPS)))
        self.w = self.eng.pack_w(np.zeros(D, np.float32))
        self.dp = int(self.w.shape[1])
        # the rank's rows of each party-stacked (Q, ...) input (all of
        # them on one device)
        self.delays = mine(torch.ones(Q, dtype=torch.int64, device=dev))
        self.delays_qm = mine(torch.ones((Q, M), dtype=torch.int64,
                                         device=dev))
        self.buf = mine(torch.zeros((Q, TAU + 1, self.dp), device=dev))
        self.bufm = mine(torch.zeros((Q, TAU + 1, self.dp, M), device=dev))
        self.tabq = mine(torch.zeros((Q, N), device=dev))
        self.fwdq = mine(torch.ones((Q, STEPS), device=dev))
        self.bwdq = mine(torch.ones((Q, STEPS), device=dev))
        self.extraq = mine(torch.zeros((Q, STEPS), dtype=torch.int64,
                                       device=dev))
        self.corruptq = mine(torch.zeros((Q, STEPS), dtype=torch.int64,
                                         device=dev))
        self._deep_pq = None
        self._serve = None
        self._deep_serve = None

    @property
    def deep_pq(self):
        if self._deep_pq is None:
            gen = torch.Generator(device=self.eng.device).manual_seed(0)
            params = deep_vfl.init_deep_vfl(gen, self.layout, D, HIDDEN,
                                            DREP)
            self._deep_pq = self.eng.pack_deep(params)
        return self._deep_pq

    @property
    def serve(self) -> ServeEngine:
        """Linear serving; two weight installs so the delta program is
        buildable."""
        if self._serve is None:
            sv = ServeEngine(self.eng, max_batch=BATCH,
                             device=self.eng.device)
            sv.set_weights(np.zeros(D, np.float32))
            sv.set_weights(np.ones(D, np.float32))
            self._serve = sv
        return self._serve

    @property
    def deep_serve(self) -> ServeEngine:
        if self._deep_serve is None:
            sv = ServeEngine(self.eng, max_batch=BATCH,
                             device=self.eng.device)
            sv.set_deep_params(self.deep_pq)
            self._deep_serve = sv
        return self._deep_serve


def entries() -> List[Entry]:
    """The 25 entries, in the reference's order."""
    lr, dlr = 0.1, 0.05

    def sgd(eng, fx):
        return eng.sgd_epoch_graph(fx.w, lr, fx.idx)

    def svrg(eng, fx):
        return eng.epoch_graph("svrg", eng.svrg_epoch, fx.w, fx.w,
                               torch.zeros_like(fx.w), lr, fx.idx)

    def saga(eng, fx):
        return eng.epoch_graph("saga", eng.saga_epoch, fx.w, fx.tabq,
                               torch.zeros_like(fx.w), lr, fx.idx)

    def multi_sgd(eng, fx):
        return eng.epoch_graph("multi_sgd", eng.multi_sgd_epoch, fx.w, lr,
                               fx.idx_m)

    def pipelined_sgd(eng, fx):
        return eng.pipelined_sgd_epoch_graph(fx.w, lr, fx.idx)

    def delayed(eng, fx):
        return eng.epoch_graph(f"delayed{TAU}", eng.delayed_sgd_epoch, fx.w,
                               fx.buf, 0, fx.delays, lr, fx.idx, TAU)

    def multi_delayed(eng, fx):
        return eng.epoch_graph(f"multi_delayed{TAU}",
                               eng.multi_delayed_sgd_epoch, fx.w, fx.bufm, 0,
                               fx.delays_qm, lr, fx.idx_m, TAU)

    def faulted_sgd(eng, fx):
        return eng.faulted_sgd_epoch_graph(fx.w, fx.buf, 0, fx.delays,
                                           fx.fwdq, fx.bwdq, fx.extraq, lr,
                                           fx.idx, TAU)

    def guarded_sgd(eng, fx):
        return eng.guarded_sgd_epoch_graph(fx.w, fx.buf, 0, fx.delays,
                                           fx.fwdq, fx.bwdq, fx.extraq,
                                           fx.corruptq, lr, fx.idx, TAU)

    def deep_sgd(eng, fx):
        return eng.deep_sgd_epoch_graph(fx.deep_pq, dlr, fx.idx)

    def deep_multi_sgd(eng, fx):
        return eng.epoch_graph("deep_multi_sgd", eng.deep_multi_sgd_epoch,
                               fx.deep_pq, dlr, fx.idx_m)

    def deep_svrg(eng, fx):
        mu = tuple(torch.zeros_like(a) for a in fx.deep_pq)
        return eng.epoch_graph("deep_svrg", eng.deep_svrg_epoch, fx.deep_pq,
                               fx.deep_pq, mu, dlr, fx.idx)

    def deep_pipelined_sgd(eng, fx):
        return eng.deep_pipelined_sgd_epoch_graph(fx.deep_pq, dlr, fx.idx)

    def deep_delayed(eng, fx):
        buf = eng.deep_delay_buffers(fx.deep_pq, TAU)
        return eng.epoch_graph(f"deep_delayed{TAU}",
                               eng.deep_delayed_sgd_epoch, fx.deep_pq, buf, 0,
                               fx.delays, dlr, fx.idx, TAU)

    def deep_faulted_sgd(eng, fx):
        buf = eng.deep_delay_buffers(fx.deep_pq, TAU)
        return eng.epoch_graph(f"deep_faulted_sgd{TAU}",
                               eng.deep_faulted_sgd_epoch, fx.deep_pq, buf, 0,
                               fx.delays, fx.fwdq, fx.bwdq, fx.extraq, dlr,
                               fx.idx, TAU)

    def deep_guarded_sgd(eng, fx):
        buf = eng.deep_delay_buffers(fx.deep_pq, TAU)
        return eng.epoch_graph(f"deep_guarded_sgd{TAU}_1",
                               eng.deep_guarded_sgd_epoch, fx.deep_pq, buf, 0,
                               fx.delays, fx.fwdq, fx.bwdq, fx.extraq,
                               fx.corruptq, dlr, fx.idx, TAU)

    # serving: the cold/miss and stale-refresh dispatches cross the party
    # axis as a training forward does; the cache hit has no party axis and
    # is checked structurally in tests/test_torch_analysis.py
    def serve_full(eng, fx):
        return fx.serve.serve_full_graph()

    def serve_delta(eng, fx):
        return fx.serve.serve_delta_graph()

    def deep_serve_full(eng, fx):
        return fx.deep_serve.serve_full_graph()

    return [
        Entry("sgd", sgd),
        Entry("svrg", svrg),
        Entry("saga", saga),
        Entry("multi_sgd", multi_sgd),
        Entry("pipelined_sgd", pipelined_sgd),
        Entry(f"delayed{TAU}", delayed, tau=TAU),
        Entry(f"multi_delayed{TAU}", multi_delayed, tau=TAU),
        Entry(f"faulted_sgd{TAU}", faulted_sgd, tau=TAU, membership=True,
              gated=True),
        Entry(f"guarded_sgd{TAU}_1", guarded_sgd, tau=TAU, membership=True,
              gated=True),
        Entry("deep_sgd", deep_sgd),
        Entry("deep_multi_sgd", deep_multi_sgd),
        Entry("deep_svrg", deep_svrg),
        Entry("deep_pipelined_sgd", deep_pipelined_sgd),
        Entry(f"deep_delayed{TAU}", deep_delayed, tau=TAU),
        Entry(f"deep_faulted_sgd{TAU}", deep_faulted_sgd, tau=TAU,
              membership=True, gated=True),
        Entry(f"deep_guarded_sgd{TAU}_1", deep_guarded_sgd, tau=TAU,
              membership=True, gated=True),
        Entry("serve", serve_full),
        Entry("serve_delta", serve_delta),
        Entry("deep_serve", deep_serve_full),
        Entry("hier_sgd", sgd, pmesh=HIER),
        Entry("hier_svrg", svrg, pmesh=HIER),
        Entry(f"hier_faulted_sgd{TAU}", faulted_sgd, tau=TAU,
              membership=True, gated=True, pmesh=HIER),
        Entry("hier_deep_sgd", deep_sgd, pmesh=HIER),
        Entry("hier_sgd_ddp", sgd, pmesh=HIER_DDP),
        Entry("hier_serve", serve_full, pmesh=HIER),
    ]


#: entry names of the quick (test-sized) matrix — the reference's
QUICK = ("sgd", f"delayed{TAU}", f"faulted_sgd{TAU}", f"guarded_sgd{TAU}_1",
         "deep_sgd", "hier_sgd", "serve")

#: the kinds ``kernel_census`` counts, with the vfl_grad launches a step
#: each makes on the card (PERF.md §6: a fresh linear step forward and
#: backward, a pipelined interior step one split launch, a deep step two
#: forwards and two backwards, SVRG's three each)
CENSUS = {"sgd": 2, "pipelined_sgd": 1, "svrg": 2, "saga": 2,
          "multi_sgd": 2, f"delayed{TAU}": 2, f"multi_delayed{TAU}": 2,
          f"faulted_sgd{TAU}": 2, f"guarded_sgd{TAU}_1": 2, "deep_sgd": 4,
          "deep_multi_sgd": 4, "deep_svrg": 6, "deep_pipelined_sgd": 1,
          f"deep_delayed{TAU}": 4, f"deep_faulted_sgd{TAU}": 4,
          f"deep_guarded_sgd{TAU}_1": 4}


def entry_names() -> List[str]:
    return [e.name for e in entries()]


def world_entries(world: str) -> List[Entry]:
    """The entries a device-mesh world runs (``MESH_WORLDS``)."""
    packing = MESH_WORLDS[world][2]
    return [e for e in entries() if e.pmesh == packing]


def analyze_entry(ent: Entry, fx: Fixture, secure: str) -> EntryReport:
    """Trace one entry on ``fx``'s engine and run the passes."""
    program = ent.trace(fx.eng, fx)
    an = Analyzer(program, membership=ent.membership).run()
    rings = ([a.to_dict() for a in ring_audit(program, ent.tau)]
             if ent.tau is not None else [])
    return EntryReport(
        name=ent.name, secure=secure, taint=finding_codes(an.findings),
        host_transfers=count_host_transfers(program),
        cross_party=len(an.boundaries), rings=rings,
        membership=ent.membership, gated=ent.gated,
        census=vfl_grad_census(program), unknown=sorted(an.unknown),
        collectives=(None if fx.eng._dist is None
                     else count_model_collectives(program)),
        released=an.released)


def fixture(secure: str, device="cuda", pmesh: Optional[PartyMesh] = None,
            indices=None, cache: Optional[Dict] = None) -> Fixture:
    """The :class:`Fixture` of ``(secure, pmesh)``: from ``cache`` (a dict
    shared by callers that use the same ``device`` and ``indices``) where
    it holds one, else a new one, kept there.  Tracing changes no
    fixture's state, so every trace may share it."""
    if cache is None:
        return Fixture(secure, device, pmesh, indices)
    if (secure, pmesh) not in cache:
        cache[secure, pmesh] = Fixture(secure, device, pmesh, indices)
    return cache[secure, pmesh]


def analyze_matrix(secure_modes: Sequence[str] = SECURE_MODES,
                   names: Optional[Sequence[str]] = None,
                   progress: Optional[Callable[[str], None]] = None,
                   device="cuda", indices=None,
                   mesh: Optional[PartyMesh] = None,
                   fixtures: Optional[Dict] = None) -> List[EntryReport]:
    """Trace and analyse the entry-point matrix: one
    :class:`EntryReport` per (security mode, entry).  With ``mesh`` (a
    ``PartyMesh`` on a device mesh; every rank of it calls) every chosen
    entry runs on it, the rank's program.  ``fixtures``, a cache as in
    :func:`fixture`, keeps the engines for the caller's later passes."""
    reports: List[EntryReport] = []
    chosen = [e for e in entries() if names is None or e.name in set(names)]
    for secure in secure_modes:
        cache = {} if fixtures is None else fixtures
        for ent in chosen:
            if progress is not None:
                progress(f"{secure}/{ent.name}")
            pmesh = ent.pmesh if mesh is None else mesh
            fx = fixture(secure, device, pmesh, indices, cache)
            reports.append(analyze_entry(ent, fx, secure))
    return reports


def check_reports(reports: Sequence[EntryReport]) -> List[str]:
    """The hard lint gates over entry reports (the reference's).  Returns
    violation messages (empty = pass)."""
    errors: List[str] = []
    for r in reports:
        where = r.key
        if ("faulted" in r.name or "guarded" in r.name) \
                and not r.membership:
            # membership-varying entries must be analysed under the
            # membership rule: a guarded epoch whose quarantine drops a
            # party while one draw masks two membership sets is a replay
            # oracle
            errors.append(f"{where}: membership-varying entry analyzed "
                          f"without membership=True (the membership rule "
                          f"is not applied)")
        if r.secure == "off":
            if r.taint.get("unmasked-boundary", 0) < 1:
                errors.append(
                    f"{where}: secure=off must flag at least one unmasked "
                    f"boundary crossing (analyzer vacuity?) — got {r.taint}")
        elif r.taint:
            errors.append(f"{where}: secure mode leaks: {r.taint}")
        if r.host_transfers != 0:
            errors.append(f"{where}: {r.host_transfers} host transfers in "
                          f"the epoch (must be 0)")
        if r.cross_party < 1:
            errors.append(f"{where}: no party-axis boundary in the program "
                          f"(walker vacuity?)")
        if r.collectives is not None and r.collectives < 1:
            errors.append(f"{where}: no model-group collective in the "
                          f"rank's program")
        for op in r.unknown:
            if op.startswith("c10d."):
                errors.append(f"{where}: no rule for the collective {op}")
        for ring in r.rings:
            if not ring["bounded"]:
                errors.append(f"{where}: ring {ring['buffer']} staleness "
                              f"bound NOT proven: {ring['notes']}")
            if bool(ring["gated"]) != r.gated:
                errors.append(f"{where}: ring {ring['buffer']} gating "
                              f"mismatch (expected gated={r.gated}, audit "
                              f"says {ring['gated']})")
        if not r.rings and "delayed" in r.name \
                and any(c.isdigit() for c in r.name):
            errors.append(f"{where}: expected ring buffers, audit found none")
    return errors


def kernel_census(names: Sequence[str] = ("sgd", "pipelined_sgd"),
                  device="cuda", indices=None,
                  mesh: Optional[PartyMesh] = None,
                  fixtures: Optional[Dict] = None) -> Dict[str, List[int]]:
    """``repro_torch.vfl_grad`` nodes in one traced step of each named
    kind, as one-element lists (the reference's per-``scan``-body
    counts): the sequential SGD step launches forward and backward (2),
    the pipelined step one split-batch launch (1).  With ``mesh``, one
    rank's; ``fixtures`` as in :func:`fixture`."""
    fx = fixture("ring", device, mesh, indices, fixtures)
    out: Dict[str, List[int]] = {}
    for ent in entries():
        if ent.name in set(names) and ent.pmesh is None:
            out[ent.name] = [vfl_grad_census(ent.trace(fx.eng, fx))]
    return out
