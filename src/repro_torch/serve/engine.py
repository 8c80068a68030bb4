"""Secure federated inference serving on the fused engine (PyTorch).

The port of ``repro.serve.engine``.  Concurrent requests are coalesced
into rank-k forward dispatches through the same masked-aggregation
boundary training uses, and a dominator-side cache of aggregated passive
partials turns repeat traffic into dominator-local work with **zero**
cross-party communication.  Routing, versioning and ``ServeStats`` follow
the reference field for field.

Request batching
----------------
A serve batch of R requests (padded to ``max_batch`` with the sentinel id
n) is one forward dispatch: each party's (R, dp) request rows against its
weight column, all q parties in ONE ``vfl_grad(mode="forward")`` launch
(the party axis is the kernel's leading dimension).  The prediction adds
the dominator's own partial (one more launch) to the cached passive sum.
Launches per dispatch: linear full and delta 2, linear hit 1; deep full 4
(two encoder layers for the parties, two for the dominator), deep hit 2.

Passive-party partial cache
---------------------------
Per sample id the dominator caches the **masked-aggregated passive sum**

    S_i = Σ_{ℓ ≥ 1} x_{i,G_ℓ} · w_{G_ℓ}          (linear)
    S_i = Σ_{ℓ ≥ 1} f_ℓ(x_{i,G_ℓ})               (deep, (d_rep,) vector)

— the output of the Algorithm-1 aggregation in which the dominator rides
with a zero payload — never any individual party's partial.  A **hit**
is one dominator matvec plus a cache read; an entry exactly one version
behind (linear) is repaired by one masked aggregation of *deltas*
x_{i,G_ℓ}·(w_ℓ − w_ℓ^prev).

Serving over a ``PartyMesh``
----------------------------
On an engine built with ``mesh=PartyMesh(...)`` every masked dispatch
(full, delta, deep full) aggregates through the engine's two-level form
(``FusedEngine._agg`` → ``secure_psum_hier``): level 1 within each slot
draws one mask stream per logical party, level 2 across the slots' sums
one per slot, fresh from the dispatch's generator.  Under ``off`` the
plain sum stays, so packed serving is flat serving bit for bit.  A data
axis is ignored: the reference runs its serve programs replicated over
the axis, and the replicas agree.

Serving over a device mesh
--------------------------
Over an engine on ``PartyMesh(mesh=DeviceMesh)`` each rank holds its
slot's parties' request rows and weight rows; the masked dispatches
aggregate over the model group (``FusedEngine._agg_dist``), each rank
drawing its own parties' streams (``FusedEngine.mask_streams``), and
every rank keeps the same replicated cache (linear: the (n+1,) passive
sums; deep: the (n+1, d_rep) masked aggregates of the passive parties'
representations).  The dominator's own work — its matvec, or its
encoding of party 0's rows with party 0's encoder and the head — reads
party 0's block, which only the rank of slot 0 holds: that rank
computes the answer and broadcasts it over the model group.  Every rank
calls ``serve`` with the same ids, and ``set_deep_params`` with
``DeepVFLParams`` or its own rows of them (``FusedEngine.pack_deep``).
The program probes trace the rank's own dispatch there; the answer's
broadcast is tagged as the release of the served answer
(``trace_tag(release=SERVED_ANSWER)``), the one unmasked value the
linter lets cross the model group (``repro_torch.analysis.taint``).  The
reference computes the answer outside the per-party program it lints;
on a device mesh the passive ranks receive it (ROADMAP C).

Where the port differs in mechanism (not in result)
---------------------------------------------------
* The cache has one extra **trash slot** at index n: pad rows scatter
  there, standing in for the reference's ``mode="drop"``.
* Duplicate ids in one batch: the reference scatters and reads the
  stored winner back, so every copy emits one value.  ``index_put_``
  with duplicate indices picks a winner non-deterministically on CUDA, so
  every copy of an id writes the value of its **last occurrence**
  (``core.algorithms.last_occurrence``): whichever write lands, the slot
  holds that one value.  The port then reads the stored value back, as
  the reference does.
* Mask streams: each masked dispatch draws from a generator seeded by
  ``(seed, version, counter)``, the counterpart of the reference's
  ``fold_in(fold_in(key, version), counter)``.  A replayed dispatch
  sequence draws identical masks, so an invalidated re-serve equals a
  fresh-cache run bit for bit; against the reference the masks differ
  and results agree to float tolerance.
* No jit, no donation: the cache tensors are updated in place.  The
  reference's jaxpr probes are ``serve_full_graph``, ``serve_delta_graph``
  and ``serve_hit_graph``: a ``make_fx`` trace of one dispatch over fake
  tensors (``core.engine.trace_program``), the serving state as its
  inputs, which ``repro_torch.analysis`` lints as it does the epochs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import last_occurrence
from repro_torch.core.deep_vfl import DeepVFLParams
from repro_torch.core.engine import FusedEngine, pack_features, trace_program
from repro_torch.core.secure_agg import SERVED_ANSWER, trace_tag


@dataclasses.dataclass
class ServeStats:
    """Host-side dispatch accounting for one :class:`ServeEngine`.

    ``full_dispatches`` are q-party masked-aggregation programs (cold /
    miss path), ``delta_dispatches`` q-party masked *delta* aggregations
    (stale-refresh path), ``hit_dispatches`` dominator-only programs with
    zero cross-party collectives.  ``cache_hits`` / ``cache_misses`` /
    ``cache_stale`` count *requests* by how their batch was routed."""

    requests: int = 0
    batches: int = 0
    full_dispatches: int = 0
    delta_dispatches: int = 0
    hit_dispatches: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_stale: int = 0

    @property
    def dispatches(self) -> int:
        return (self.full_dispatches + self.delta_dispatches
                + self.hit_dispatches)


class ServeEngine:
    """Batched secure inference over a :class:`FusedEngine`.

    ``engine`` supplies the vertical layout, the security configuration
    (``EngineConfig.secure`` — off/two_tree/ring, two-level when the
    engine is bound to a packed ``PartyMesh``) and the contraction
    (``FusedEngine._fwd``); ``x`` optionally replaces the engine's
    features with a dedicated serving universe (same vertical layout,
    packed onto ``device``).
    Weights come from :meth:`set_weights` (linear) or
    :meth:`set_deep_params` (deep); every update bumps the cache version.

    ``device`` defaults to ``"cuda"`` and must be the engine's device.
    """

    def __init__(self, engine: FusedEngine, x=None, *, max_batch: int = 64,
                 cache: bool = True, delta_refresh: bool = True,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if self.device != engine.device:
            raise ValueError(f"ServeEngine on {self.device} over an engine "
                             f"on {engine.device}")
        self.eng = engine
        self.layout = engine.layout
        self.q = engine.q
        self.xs = engine.xs if x is None else \
            pack_features(x, engine.layout, self.device, engine.parties)
        self.n = int(self.xs.shape[1])
        self.dp = int(self.xs.shape[2])
        self.max_batch = int(max_batch)
        self.cache_enabled = bool(cache)
        self.delta_refresh = bool(delta_refresh)
        # payload selector: the dominator (logical party 0) rides the
        # masked aggregation with a zero payload, so the collective's
        # output is exactly the passive sum
        self._pfq = torch.tensor([float(p != 0) for p in engine.parties],
                                 device=self.device)
        self.seed = int(seed)
        self.version = 0
        self._counter = 0          # masked dispatches within this version
        self.deep = False
        self._wq = None            # (q, dp) linear iterate
        self._prev_wq = None       # previous version (delta refresh)
        self._pq = None            # (w1q, b1q, w2q, headq) deep params
        self._csum = None          # (n+1,) or (n+1, d_rep); slot n = trash
        self._ver = np.full((self.n,), -1, np.int64)   # entry versions
        self.stats = ServeStats()

    # -- weights / invalidation ----------------------------------------------

    def set_weights(self, w) -> None:
        """Install a linear iterate — ``(d,)`` coordinate vector or the
        party-stacked ``(q, dp)`` form.  Any update after the first bumps
        the cache version: every cached passive sum was computed under
        the old passive blocks and is no longer a hit (linear entries
        exactly one version behind stay repairable via the masked delta
        aggregation while ``delta_refresh`` holds)."""
        wt = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        wq = wt.clone() if wt.dim() == 2 else self.eng.pack_w(wt)
        if tuple(wq.shape) != (self.eng.qloc, self.dp):
            raise ValueError(f"weights shape {tuple(wq.shape)} != (q, dp) = "
                             f"{(self.eng.qloc, self.dp)}")
        had = self._wq is not None or self._pq is not None
        self._prev_wq = self._wq if (self.delta_refresh
                                     and not self.deep) else None
        self._wq = wq
        self._pq = None
        self.deep = False
        if had:
            self._bump_version()
        if self._csum is None or self._csum.dim() != 1:
            self._alloc_cache((self.n + 1,))

    def set_deep_params(self, params) -> None:
        """Install deep (party-local encoder) parameters —
        ``DeepVFLParams`` or the party-stacked ``(w1q, b1q, w2q, headq)``
        from ``FusedEngine.pack_deep``.  Deep updates always invalidate
        outright: an encoder change has no linear delta structure, so
        stale entries are recomputed, never repaired.  On a device mesh
        the party-stacked form is this rank's rows."""
        pq = self.eng.pack_deep(params) if isinstance(params, DeepVFLParams) \
            else tuple(params)
        if len(pq) != 4:
            raise ValueError("deep params must be the 4-tuple "
                             "(w1q, b1q, w2q, headq)")
        if any(np.shape(a)[0] != self.eng.qloc for a in pq):
            raise ValueError(f"deep params hold "
                             f"{[np.shape(a)[0] for a in pq]} party rows; "
                             f"the engine holds {self.eng.qloc}")
        had = self._wq is not None or self._pq is not None
        self._pq = tuple(torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device).contiguous()
                         for a in pq)
        self._wq = None
        self._prev_wq = None
        self.deep = True
        d_rep = int(self._pq[2].shape[2])
        if had:
            self._bump_version()
        if self._csum is None or self._csum.dim() != 2 \
                or self._csum.shape[1] != d_rep:
            self._alloc_cache((self.n + 1, d_rep))

    def _bump_version(self) -> None:
        self.version += 1
        self._counter = 0

    def _alloc_cache(self, shape) -> None:
        self._csum = torch.zeros(shape, dtype=torch.float32,
                                 device=self.device)
        self._ver = np.full((self.n,), -1, np.int64)

    def reset_cache(self) -> None:
        """Drop every cached entry (cold-start; benchmarking helper)."""
        if self._csum is not None:
            self._alloc_cache(tuple(self._csum.shape))

    def _dispatch_gen(self):
        """Fresh mask stream per masked dispatch, seeded by (seed,
        version, counter): no stream is reused across dispatches, and a
        replayed (version, counter) sequence draws identical masks (on a
        device mesh, the rank's own parties' streams)."""
        gen = self.eng.mask_streams(self.seed, self.version, self._counter)
        self._counter += 1
        return gen

    def _dominator(self, fn):
        """The answer ``fn()`` of the dominator's matvec: computed here on
        one device; on a device mesh by the rank holding party 0 and
        broadcast over the model group."""
        eng = self.eng
        if eng._dist is None:
            return fn()
        import torch.distributed as dist
        grp = eng._mgroup
        out = fn() if eng.parties[0] == 0 else torch.empty(
            (self.max_batch,), dtype=torch.float32, device=self.device)
        with trace_tag(collective="model", release=SERVED_ANSWER):
            dist.broadcast(out, dist.get_global_rank(grp, 0), group=grp)
        return out

    # -- encoder and cache writes ----------------------------------------------

    def _req_encode(self, rows, w1, b1, w2):
        """(R, dp) request rows -> (R, d_rep) encoder representations (the
        deep partial), both layers kernel-routed with hidden/d_rep as the
        M axis; with the party axis every tensor carries a leading q."""
        h = torch.tanh(self.eng._fwd(rows, w1) + b1.unsqueeze(-2))
        return self.eng._fwd(h, w2)

    def _store(self, ids, values):
        # the last occurrence of a duplicate id wins, on every device
        self._csum[ids] = values[last_occurrence(ids)]

    # -- device programs -------------------------------------------------------

    def _full(self, ids):
        idsc = ids.clamp(max=self.n - 1)
        wq = self._wq
        # (q, R, dp) request rows · (q, dp) weight columns: every party's
        # partials in one launch
        z = self.eng._fwd(self.xs[:, idsc], wq)                  # (q, R)
        # dominator payload is zero; every transmitted partial is masked
        # by the engine's configured aggregation
        psum = self.eng._agg(self._pfq[:, None] * z, self._dispatch_gen())
        # scatter first, predict from the STORED values: every row that
        # repeats an id emits the one stored winner, so a later hit
        # replays this dispatch bit-exactly
        self._store(ids, psum)
        return self._dominator(
            lambda: self.eng._fwd(self.xs[0][idsc], wq[0]) + self._csum[ids])

    def _delta(self, ids, stale):
        idsc = ids.clamp(max=self.n - 1)
        wq = self._wq
        dz = self.eng._fwd(self.xs[:, idsc], wq - self._prev_wq)
        # only rows flagged stale contribute their delta; rows already
        # current ride the collective as zero payload
        dsum = self.eng._agg(self._pfq[:, None] * stale[None, :] * dz,
                             self._dispatch_gen())
        self._store(ids, self._csum[ids] + dsum)
        return self._dominator(
            lambda: self.eng._fwd(self.xs[0][idsc], wq[0]) + self._csum[ids])

    def _hit(self, ids):
        idsc = ids.clamp(max=self.n - 1)
        if self.deep:
            return self._dominator(lambda: self._deep_answer(idsc, ids))
        return self._dominator(lambda: self.eng._fwd(
            self.xs[0][idsc], self._wq[0]) + self._csum[ids])

    def _deep_full(self, ids):
        idsc = ids.clamp(max=self.n - 1)
        w1q, b1q, w2q, _ = self._pq
        rep = self._req_encode(self.xs[:, idsc], w1q, b1q, w2q)  # (q,R,dr)
        psum = self.eng._agg(self._pfq[:, None, None] * rep,
                             self._dispatch_gen())
        self._store(ids, psum)    # scatter-then-read
        return self._dominator(lambda: self._deep_answer(idsc, ids))

    def _deep_answer(self, idsc, ids):
        """The dominator's deep answer: party 0's own encoding of its
        request rows plus the cached passive aggregate, through the
        head."""
        w1q, b1q, w2q, headq = self._pq
        rep0 = self._req_encode(self.xs[0][idsc], w1q[0], b1q[0], w2q[0])
        return (rep0 + self._csum[ids]) @ headq[0]

    # -- program probes (the analysis matrix, tests) -------------------------

    def _program_graph(self, program, **inputs):
        """Trace ``program(state)`` for a batch of ``max_batch`` zero ids:
        the ids, the cache and the installed weights are the graph's
        inputs (the weights party-stacked, dim 0), the serving universe
        its private source.  Nothing runs; no state changes.  On a
        device mesh, the rank's own program."""
        self._require_weights()
        state = {"ids": torch.zeros((self.max_batch,), dtype=torch.int64,
                                    device=self.device),
                 "csum": self._csum, **inputs}
        if self.deep:
            state.update(zip(("w1", "b1", "w2", "head"), self._pq))
        else:
            state["wq"] = self._wq
            state["prev_wq"] = self._wq if self._prev_wq is None \
                else self._prev_wq
        saved = (self._csum, self._wq, self._prev_wq, self._pq,
                 self._counter)

        def fn(b):
            self._csum = b["csum"]
            if self.deep:
                self._pq = tuple(b[k] for k in ("w1", "b1", "w2", "head"))
            else:
                self._wq, self._prev_wq = b["wq"], b["prev_wq"]
            try:
                program(b)
            finally:
                (self._csum, self._wq, self._prev_wq, self._pq,
                 self._counter) = saved

        return trace_program(
            fn, state, {k: (None if k in ("ids", "csum", "stale") else 0)
                        for k in state},
            ((self.xs, 0, True), (self._pfq, 0, False))
            + self.eng.party_consts())

    def serve_full_graph(self):
        """The cold/miss dispatch's program (``serve_full_jaxpr``'s
        counterpart): the masked aggregation of the passive partials."""
        return self._program_graph(
            lambda b: (self._deep_full if self.deep else self._full)(
                b["ids"]))

    def serve_delta_graph(self):
        """The stale-refresh dispatch's program: the masked aggregation
        of the passive deltas (linear only)."""
        if self.deep:
            raise ValueError("delta refresh is linear-only")
        return self._program_graph(
            lambda b: self._delta(b["ids"], b["stale"]),
            stale=torch.ones((self.max_batch,), device=self.device))

    def serve_hit_graph(self):
        """The cache-hit dispatch's program: dominator-local, with no
        party-axis reduction."""
        return self._program_graph(lambda b: self._hit(b["ids"]))

    # -- the serving entry point ----------------------------------------------

    def _require_weights(self):
        if self._wq is None and self._pq is None:
            raise ValueError("no weights installed — call set_weights() "
                             "or set_deep_params() first")

    def serve(self, ids) -> np.ndarray:
        """Serve a coalesced request batch: ``ids`` are sample ids into
        the serving universe; returns the per-request scores (wᵀx for the
        linear objectives, the logit for the deep path).  Batches larger
        than ``max_batch`` are chunked; each chunk is routed to the hit /
        delta / full program by its cache state and costs exactly one
        dispatch."""
        self._require_weights()
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            return np.zeros((0,), np.float32)
        if ids.min() < 0 or ids.max() >= self.n:
            raise ValueError(f"sample ids must lie in [0, {self.n})")
        out = np.empty(ids.shape[0], np.float32)
        for lo in range(0, ids.shape[0], self.max_batch):
            chunk = ids[lo:lo + self.max_batch]
            out[lo:lo + chunk.shape[0]] = self._serve_chunk(chunk)
        return out

    def _serve_chunk(self, ids: np.ndarray) -> np.ndarray:
        count = ids.shape[0]
        padded = np.full((self.max_batch,), self.n, np.int64)
        padded[:count] = ids
        pid = torch.from_numpy(padded).to(self.device)
        ver = self._ver[ids]
        self.stats.requests += count
        self.stats.batches += 1
        if self.cache_enabled and np.all(ver == self.version):
            preds = self._hit(pid)
            self.stats.hit_dispatches += 1
            self.stats.cache_hits += count
        elif (self.cache_enabled and self.delta_refresh and not self.deep
              and self._prev_wq is not None
              and np.all(ver >= self.version - 1)):
            stale = np.zeros((self.max_batch,), np.float32)
            stale[:count] = (ver < self.version).astype(np.float32)
            preds = self._delta(pid, torch.from_numpy(stale).to(self.device))
            self._ver[ids] = self.version
            self.stats.delta_dispatches += 1
            self.stats.cache_stale += int(stale.sum())
            self.stats.cache_hits += count - int(stale.sum())
        else:
            preds = self._deep_full(pid) if self.deep else self._full(pid)
            if self.cache_enabled:
                self._ver[ids] = self.version
            self.stats.full_dispatches += 1
            self.stats.cache_misses += count
        return preds[:count].cpu().numpy()
