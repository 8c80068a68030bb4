"""BAPA: the bilevel asynchronous parallel architecture (thread simulation).

The port of ``repro.core.async_engine``.  It mirrors the paper's own
experimental harness (§7: parties are thread groups on one multi-core
machine).  Two parallel levels:

* upper / inter-party (distributed-memory): each *active* party runs a
  dominator thread that repeatedly (i) draws a sample index, (ii) gathers
  the parties' masked partial products through the two-tree protocol
  (Algorithm 1), (iii) computes ϑ, (iv) pushes (ϑ, i) to every party's
  inbox;
* lower / intra-party (shared-memory): every party (active and passive)
  runs k collaborator threads that drain the inbox and apply BUM updates to
  the party's block in shared memory (Alg. 3), with deliberately lock-free
  reads (the paper's "inconsistent read" ŵ).

``run_sync`` ("VFB") performs the same updates behind a barrier; with a
straggler party this is what the paper's Figs. 3/4 compare against.
Per-party speed factors simulate unbalanced resources.  This module is the
wall-clock fidelity reference (real races, inconsistent reads,
stragglers); the performance path is the fused engine, whose
multi-dominator epochs replay the m dominator streams deterministically.

Where the work runs
-------------------
The threads, queues, sleeps, bounded inboxes and lock-free reads stay on
the host, as in the reference.  The parties' arithmetic runs on
``device`` through the hand-written ``vfl_grad`` kernel:

* ``x`` is packed once into the party-stacked (q, n, dp) tensor
  (``core.engine.pack_features``); the shared store ``_Shared.w`` is a
  float32 (q, dp) tensor on the device;
* a dominator iteration draws ``ib`` and then its masks from the
  reference's generator (``default_rng(seed + 1000 + a)``), so each
  dominator's index stream is the reference's; all q parties' partials
  come from **one** forward launch over their gathered (q, B, dp) rows;
  one ``.cpu()`` copy of the (q, B) partials stands for the messages that
  cross the party boundary, which go through the host-side Algorithm 1
  (``secure_aggregate_host`` over ``trees.default_tree_pair(q)``, or
  ``secure_aggregate_survivors`` while a party is down); ϑ is computed on
  the host from the aggregate, as the reference computes it, and copied
  to the device once;
* a collaborator update (``_apply_update``) is **one** backward launch on
  its party's rows (a party axis of 1) giving x_pᵀϑ + λŵ_p, the ℓ2 term
  read from the block in the kernel (``w=``), then the in-place add under
  the party's lock: a gather, the launch and the add.  A regulariser that
  is not ℓ2 launches with ``w=None`` and adds λ∇g(ŵ_p) beside it;
* ``run_sync`` runs one forward launch and one backward launch for all
  parties an iteration: every party updates from the same ϑ in lockstep;
* the objective probe runs on the device (one forward launch over all n
  samples) and ends in a host read.

So ``vfl_grad``'s launches are: ``vfl_forward_narrow`` once a dominator
iteration (``AsyncResult.iterations``; in ``run_sync`` every iteration)
plus once a probe (``len(loss_trace)``), and ``vfl_backward_rows`` once an
applied update in ``run_async`` (``updates``) and once an iteration in
``run_sync`` (``updates / q``).

In ``run_async`` one launcher thread (``_Launcher``) issues all of this
device work, in the order the other threads submit it, which is the order
the one stream runs it in anyway: a dominator hands it the read of ŵ,
then the forward and copy, and waits for the partials; a collaborator
hands it its update and goes on, with at most one update of its own in
flight.  Every torch call releases the interpreter lock, so when each of
27 threads made its own calls they handed the lock over at each call and
met in the driver's locks: on an H100's host 24 threads made 1,295
updates a second where one made 10,677 (``tools/async_probe.py``,
PERF.md).  Each job is also as few torch calls as it can be: the ids and
ϑ go to the device without waiting for the stream, and the partials'
copy is the only wait of a dominator iteration.

Where the port differs in mechanism (not in result)
---------------------------------------------------
* The store is float32 on the device; the reference's is float64 on the
  host, updated from float32 arithmetic.  ``run_sync`` agrees with the
  reference to float32 rounding.
* ``_Shared.read_inconsistent`` is a device ``clone()``, and a
  collaborator's local read ŵ_p is the block itself where its backward
  kernel runs.  All work goes onto one stream, so either read sees the
  updates submitted before it and none after: no more consistent than
  the reference's unlocked numpy copy, which may interleave with
  concurrent writes.
* The threads hand their device work to one launcher thread; the
  reference's threads do their own numpy arithmetic.  An update counts
  when it is launched, so a run may apply a few updates past its target
  (at most one a collaborator thread), as the reference's may.
* One forward launch gives every party's partial; the reference computes
  them in a loop over the parties.
* ``AsyncResult.iterations`` counts the dominator iterations, which the
  reference does not report.
* A thread that raises stops the run; the first exception is raised to
  the caller after the join.

Device rule: ``run_async`` and ``run_sync`` default to ``device="cuda"``
and raise without a card; tests pass ``device="cpu"``, where the kernel
wrapper runs its plain version.
"""
from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import trees as trees_lib
from repro_torch.core.algorithms import PartyLayout
from repro_torch.core.engine import pack_features, unpack_vec
from repro_torch.core.faults import FaultEvent, FaultTrace
from repro_torch.core.losses import Problem, l2_reg_grad
from repro_torch.core.secure_agg import (secure_aggregate_host,
                                         secure_aggregate_survivors)
from repro_torch.kernels import ops


@dataclasses.dataclass
class AsyncResult:
    w: np.ndarray
    wall_time: float
    updates: int
    loss_trace: List[tuple]  # (wall_time, epochs_done, objective)
    # realized sample-passes (updates / q · batch / n): what actually ran,
    # which a wall-clock cutoff can leave short of total_epochs
    epochs: float = 0.0
    # True when the run hit max_wall before reaching target updates
    timed_out: bool = False
    # the REALIZED fault trace (a faults.FaultTrace) when a
    # ThreadFaultPlan was injected: what actually happened under real
    # concurrency, in the event format the fused engine replays
    fault_trace: object = None
    # dominator iterations run (one forward launch each); in run_sync,
    # the iterations
    iterations: int = 0


@dataclasses.dataclass
class TransportKnobs:
    """Timing constants of the thread transport.

    * ``put_timeout`` — per-attempt inbox put timeout on the no-fault
      path (the bounded-τ₂ blocking retry loop re-arms on expiry);
    * ``get_timeout`` — collaborator inbox poll timeout;
    * ``crashed_poll`` — a crashed dominator's idle re-check period;
    * ``frozen_poll`` — a crashed collaborator's idle re-check period.
    """

    put_timeout: float = 0.05
    get_timeout: float = 0.05
    crashed_poll: float = 0.005
    frozen_poll: float = 0.002

    def validate(self) -> None:
        for name in ("put_timeout", "get_timeout", "crashed_poll",
                     "frozen_poll"):
            if getattr(self, name) <= 0:
                raise ValueError(f"TransportKnobs.{name} must be > 0")


@dataclasses.dataclass
class ThreadFaultPlan:
    """Fault injection for the thread simulation.

    ``crash_at``/``rejoin_at`` map party id → the global update count at
    which the party crashes (its collaborators stop applying, dominators
    exclude it from aggregation and delivery) / rejoins.  While any plan
    is active, ϑ delivery uses a **bounded** retry with exponential
    backoff — ``put_retries`` attempts starting at ``put_backoff``
    seconds — and a delivery that exhausts its retries is recorded as a
    realized ``drop_msg`` (the party missed that update), instead of the
    no-fault path's unbounded blocking retry.
    """

    crash_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    rejoin_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    put_retries: int = 3
    put_backoff: float = 0.02

    def validate(self, layout: PartyLayout) -> None:
        for p in list(self.crash_at) + list(self.rejoin_at):
            if not 0 <= p < layout.q:
                raise ValueError(f"fault plan names party {p} outside "
                                 f"[0, {layout.q})")
        for p, r in self.rejoin_at.items():
            if p not in self.crash_at:
                raise ValueError(f"rejoin_at for party {p} without a "
                                 "crash_at")
            if r <= self.crash_at[p]:
                raise ValueError(f"party {p} rejoin count {r} <= crash "
                                 f"count {self.crash_at[p]}")
        if all(p in self.crash_at for p in range(layout.m)):
            raise ValueError(
                "fault plan crashes every active party; at least one "
                "dominator must stay alive to compute ϑ")


def _sanitize_events(raw, q: int, steps: int):
    """Order raw realized events and drop racy illegal ones (e.g. a
    drop_msg recorded in the instant a party crashed) so the trace always
    compiles for device-side replay."""
    down = [False] * q
    out = []
    for kind, p, step in sorted(raw, key=lambda e: (e[2], e[0] != "crash")):
        step = min(max(step, 0), steps - 1)
        if kind == "crash" and not down[p]:
            down[p] = True
            out.append(FaultEvent(step, p, "crash"))
        elif kind == "rejoin" and down[p]:
            down[p] = False
            out.append(FaultEvent(step, p, "rejoin"))
        elif kind == "drop_msg" and not down[p]:
            out.append(FaultEvent(step, p, "drop_msg"))
    return tuple(out)


class _Shared:
    """Shared parameter store: the party-stacked (q, dp) float32 iterate on
    the device, per-party blocks with tiny critical sections.  ``blocks[p]``
    is party p's (1, dp, 1) view, the shape the kernel takes with a party
    axis of 1."""

    def __init__(self, dp: int, layout: PartyLayout, device):
        self.w = torch.zeros((layout.q, dp), dtype=torch.float32,
                             device=device)
        self.blocks = [self.w[p:p + 1, :, None] for p in range(layout.q)]
        self.layout = layout
        self.locks = [threading.Lock() for _ in range(layout.q)]
        self.update_count = 0
        self.iterations = 0
        self.count_lock = threading.Lock()

    def read_inconsistent(self) -> torch.Tensor:
        # deliberately unlocked: ŵ may interleave with concurrent writes
        return self.w[:, :, None].clone()                    # (q, dp, 1)

    def add_to_block(self, p: int, delta: torch.Tensor, alpha: float = 1.0):
        with self.locks[p]:
            self.blocks[p].add_(delta, alpha=alpha)
        with self.count_lock:
            self.update_count += 1


def _bum_grad(problem: Problem, rows, w, theta):
    """x_pᵀϑ + λ∇g(w) for each party of ``rows`` (P, B, dp), w (P, dp, 1),
    ϑ (P, B, 1), in one backward launch: an ℓ2 term in the kernel
    (``w=``), another regulariser added beside it."""
    if problem.reg_grad is l2_reg_grad:
        return ops.vfl_grad(rows, w, theta, problem.lam, mode="backward",
                            denom=1.0)[1]
    g = ops.vfl_grad(rows, None, theta, mode="backward", denom=1.0)[1]
    return g.add_(problem.reg_grad(w), alpha=problem.lam)


def _apply_update(problem: Problem, xsp, shared: _Shared, p: int, theta, ibt,
                  lr: float) -> None:
    """A collaborator's BUM update of party p's block from the received
    (ϑ, i), ϑ shaped (1, B, 1): the gradient on the party's gathered rows,
    λ∇g read from the unlocked block where the kernel runs (in stream
    order, as inconsistent as the reference's copy), then the in-place add
    under the party's lock."""
    g = _bum_grad(problem, xsp[p].index_select(1, ibt), shared.blocks[p],
                  theta)
    shared.add_to_block(p, g, alpha=-lr)


def _objective(problem: Problem, xs, y, w) -> float:
    """f(w) over all n samples, w (q, dp, 1): one forward launch for every
    party's partials, then a host read."""
    agg = ops.vfl_grad(xs, w, mode="forward")[0].sum(0)[:, 0]
    return float(problem.loss(agg, y).mean()
                 + problem.lam * problem.reg(w).sum())


def _setup(x, y, layout, device):
    """The device, the packed (q, n, dp) features, its q (1, n, dp) party
    views and the labels on the device."""
    dev = resolve_device(device)
    xs = pack_features(x, layout, dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    return dev, xs, xs.split(1), yt


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev`` without a wait on the stream: a pageable
    source is staged before the copy returns."""
    return torch.from_numpy(a).to(dev, non_blocking=True)


class _Job:
    """One piece of device work handed to the ``_Launcher``."""

    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error = None

    def result(self):
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.value


class _Launcher:
    """One host thread that issues a run's device work, in the order it is
    submitted: the order the one stream runs it in anyway.  The other
    threads only hand it work, so no two threads are ever inside torch at
    once and none waits on the interpreter lock with work queued.  A job
    that raises stops the run; its exception is relayed like a thread's.
    """

    def __init__(self, fail):
        self._q = queue.SimpleQueue()
        self._fail = fail
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, fn, *args) -> _Job:
        job = _Job()
        self._q.put((fn, args, job))
        return job

    def call(self, fn, *args):
        return self.submit(fn, *args).result()

    def close(self) -> None:
        """Run what is queued, then end the thread."""
        self._q.put(None)
        self._thread.join()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, job = item
            try:
                job.value = fn(*args)
            except Exception as e:              # relayed to the caller
                job.error = e
                self._fail(e)
            job.done.set()


def run_async(
    problem: Problem,
    x,
    y,
    layout: PartyLayout,
    lr: float = 0.1,
    batch: int = 16,
    total_epochs: float = 10.0,
    threads_per_party: int = 2,
    speed_factors: Optional[List[float]] = None,
    base_delay: float = 2e-3,
    seed: int = 0,
    secure: bool = True,
    max_wall: float = 120.0,
    fault_plan: Optional[ThreadFaultPlan] = None,
    transport: Optional[TransportKnobs] = None,
    device="cuda",
) -> AsyncResult:
    """Run VFB² asynchronously until ``total_epochs`` sample-passes happen.

    ``max_wall`` bounds the wall clock: a run that hasn't reached its
    update target by then stops with ``timed_out=True`` and an explicit
    ``RuntimeWarning`` (never a silent truncation); ``result.epochs``
    reports the sample-passes actually realized.

    ``fault_plan`` injects crashes/rejoins at update-count thresholds and
    switches ϑ delivery to bounded-retry-with-backoff (exhausted retries
    become realized ``drop_msg`` events).  While a party is down its
    collaborators stop applying (its block freezes), and dominators
    exclude it from aggregation (re-keying the masks over the survivor
    set via ``secure_aggregate_survivors``) and from delivery.  The faults
    that actually happened come back as ``result.fault_trace`` (a
    ``faults.FaultTrace``), replayable on the fused engine.

    ``x`` (n, d) and ``y`` (n,) are numpy arrays or tensors; the parties'
    arithmetic runs on ``device`` (default the card; raises without one).
    A thread that raises stops the run, and its exception is raised here.
    """
    dev, xs, xsp, yt = _setup(x, y, layout, device)
    n, dp = int(xs.shape[1]), int(xs.shape[2])
    q, m = layout.q, layout.m
    yh = yt.cpu().numpy()               # the dominators' labels, on host
    speed_factors = speed_factors or [1.0] * q
    shared = _Shared(dp, layout, dev)
    inboxes = [queue.Queue(maxsize=4 * max(1, m)) for _ in range(q)]
    t1, t2 = trees_lib.default_tree_pair(q)
    stop = threading.Event()
    target_updates = int(total_epochs * n / batch) * q  # each ϑ → q updates
    trace: List[tuple] = []
    steps_total = max(1, int(total_epochs * n / batch))
    down = [threading.Event() for _ in range(q)]
    raw_events: List[tuple] = []            # (kind, party, step)
    ev_lock = threading.Lock()
    errors: List[Exception] = []
    if fault_plan is not None:
        fault_plan.validate(layout)
    knobs = transport if transport is not None else TransportKnobs()
    knobs.validate()

    def cur_step() -> int:
        return min(shared.update_count // q, steps_total - 1)

    def record(kind: str, p: int):
        with ev_lock:
            raw_events.append((kind, p, cur_step()))

    crashed = set()
    plan_lock = threading.Lock()

    def apply_plan():
        """Fire crash/rejoin thresholds against the live update counter:
        from every collaborator after each applied update, and from the
        monitor loop (so a stalled system still moves through its
        schedule)."""
        if fault_plan is None:
            return
        cnt = shared.update_count
        with plan_lock:
            for p, c in fault_plan.crash_at.items():
                if p not in crashed and cnt >= c:
                    crashed.add(p)
                    down[p].set()
                    record("crash", p)
            for p, r in fault_plan.rejoin_at.items():
                if p in crashed and down[p].is_set() and cnt >= r:
                    down[p].clear()
                    record("rejoin", p)

    def deliver(p: int, msg) -> None:
        if fault_plan is None:
            while not stop.is_set():
                try:  # bounded inboxes = bounded communication delay τ₂
                    inboxes[p].put(msg, timeout=knobs.put_timeout)
                    return
                except queue.Full:
                    continue
            return
        # fault regime: bounded retry with exponential backoff; an
        # exhausted delivery is a realized drop_msg, not a hang
        for attempt in range(fault_plan.put_retries):
            if stop.is_set():
                return
            try:
                inboxes[p].put(
                    msg, timeout=fault_plan.put_backoff * (2 ** attempt))
                return
            except queue.Full:
                continue
        record("drop_msg", p)

    def dominator(a: int):
        rng = np.random.default_rng(seed + 1000 + a)
        while not stop.is_set():
            if down[a].is_set():        # crashed dominator: fully silent
                time.sleep(knobs.crashed_poll)
                continue
            ib = rng.integers(0, n, size=batch)
            w_hat = launcher.submit(shared.read_inconsistent)
            # the parties compute their partials concurrently; the
            # dominator waits for the slowest one
            time.sleep(base_delay * max(speed_factors))
            alive = [not down[p].is_set() for p in range(q)]
            # every party's partial in one launch; the host copy is the
            # parties' messages (Algorithm 1 runs on host values)
            ibt, zq = launcher.call(partials_of, w_hat, ib)
            partials = list(zq)
            if secure and all(alive):
                agg, _ = secure_aggregate_host(partials, rng, t1, t2)
            elif secure:
                agg, _ = secure_aggregate_survivors(partials, alive, rng)
            else:
                agg = np.sum([z for p, z in enumerate(partials)
                              if alive[p]], axis=0)
            theta = problem.theta(
                torch.from_numpy(np.asarray(agg, np.float32)),
                torch.from_numpy(yh[ib])) / batch
            theta = launcher.submit(_to_device, theta.numpy().reshape(
                1, batch, 1), dev)
            for p in range(q):  # backward distribution of (ϑ, i)
                if not alive[p]:
                    continue            # no delivery to a crashed party
                deliver(p, (theta, ibt))

    def partials_of(w_hat, ib):
        ibt = _to_device(ib, dev)
        zq = ops.vfl_grad(xs.index_select(1, ibt), w_hat.value,
                          mode="forward")[0]
        with shared.count_lock:
            shared.iterations += 1
        return ibt, zq.cpu().numpy()[:, :, 0]

    def update(p, theta, ibt):
        # ϑ's copy was submitted before this job, so it has run
        _apply_update(problem, xsp, shared, p, theta.value, ibt, lr)

    def collaborator(p: int):
        last = None
        while not stop.is_set():
            if down[p].is_set():        # crashed party: block frozen
                time.sleep(knobs.frozen_poll)
                continue
            try:
                theta, ibt = inboxes[p].get(timeout=knobs.get_timeout)
            except queue.Empty:
                continue
            time.sleep(base_delay * speed_factors[p])
            if last is not None:
                last.result()           # one update in flight a thread
            last = launcher.submit(update, p, theta, ibt)
            apply_plan()
            if shared.update_count >= target_updates:
                stop.set()

    def fail(e):
        with ev_lock:
            errors.append(e)
        stop.set()

    def guarded(body):
        def run(*args):
            try:
                body(*args)
            except Exception as e:          # relayed to the caller
                fail(e)
        return run

    def probe():
        return _objective(problem, xs, yt, shared.read_inconsistent())

    sys.setswitchinterval(0.0005)  # fine-grained GIL switching (1-core sim)
    threads = [threading.Thread(target=guarded(dominator), args=(a,),
                                daemon=True) for a in range(m)]
    for p in range(q):
        for _ in range(threads_per_party):
            threads.append(threading.Thread(target=guarded(collaborator),
                                            args=(p,), daemon=True))
    t0 = time.perf_counter()
    launcher = _Launcher(fail)
    for th in threads:
        th.start()
    next_probe = 0.05
    timed_out = False
    try:
        while not stop.is_set():
            time.sleep(0.01)
            apply_plan()
            el = time.perf_counter() - t0
            if el >= next_probe:
                eps = shared.update_count / q * batch / n
                trace.append((el, eps, launcher.call(probe)))
                next_probe = el + 0.05
            if el > max_wall:
                timed_out = True
                warnings.warn(
                    f"run_async hit the {max_wall:.0f}s wall-clock bound at "
                    f"{shared.update_count}/{target_updates} updates "
                    f"({shared.update_count / q * batch / n:.2f} of "
                    f"{total_epochs} epochs); returning the partial run "
                    "(timed_out=True)", RuntimeWarning)
                stop.set()
    finally:                        # a failed probe stops the run too
        stop.set()
        for th in threads:
            th.join(timeout=2.0)
        launcher.close()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    trace.append((wall, shared.update_count / q * batch / n, probe()))
    ftrace = None
    if fault_plan is not None:
        ftrace = FaultTrace(q=q, steps=steps_total,
                            events=_sanitize_events(raw_events, q,
                                                    steps_total))
    return AsyncResult(w=unpack_vec(shared.w, layout).astype(np.float64),
                       wall_time=wall, updates=shared.update_count,
                       loss_trace=trace,
                       epochs=shared.update_count / q * batch / n,
                       timed_out=timed_out, fault_trace=ftrace,
                       iterations=shared.iterations)


def run_sync(
    problem: Problem,
    x,
    y,
    layout: PartyLayout,
    lr: float = 0.1,
    batch: int = 16,
    total_epochs: float = 10.0,
    speed_factors: Optional[List[float]] = None,
    base_delay: float = 2e-3,
    seed: int = 0,
    device="cuda",
) -> AsyncResult:
    """Synchronous VFB (BUM without asynchrony): barrier per iteration.

    Every iteration waits for the *slowest* party twice (forward partials
    and collaborative updates) — the straggler dominates wall time.  The
    iteration's index draw is the reference's (``default_rng(seed)``), so
    the run is SGD (``algorithms.sgd_epoch``) on that schedule.  One
    forward and one backward launch an iteration serve all parties, on
    ``device`` (default the card; raises without one).
    """
    dev, xs, _, yt = _setup(x, y, layout, device)
    q, n, dp = xs.shape
    speed_factors = speed_factors or [1.0] * q
    rng = np.random.default_rng(seed)
    w = torch.zeros((q, dp, 1), dtype=torch.float32, device=dev)
    iters = int(total_epochs * n / batch)
    trace: List[tuple] = []
    t0 = time.perf_counter()
    probe_every = max(1, iters // 40)
    for it in range(iters):
        ib = rng.integers(0, n, size=batch)
        # forward barrier: wait for the slowest party's partial
        time.sleep(base_delay * max(speed_factors))
        ibt = _to_device(ib, dev)
        rows = xs.index_select(1, ibt)                       # (q, B, dp)
        agg = ops.vfl_grad(rows, w, mode="forward")[0].sum(0)[:, 0]
        theta = (problem.theta(agg, yt.index_select(0, ibt)) / batch) \
            .view(1, batch, 1).expand(q, batch, 1)
        # update barrier: all parties update in lockstep, straggler gates
        time.sleep(base_delay * max(speed_factors))
        w.add_(_bum_grad(problem, rows, w, theta), alpha=-lr)
        if it % probe_every == 0:
            trace.append((time.perf_counter() - t0, it * batch / n,
                          _objective(problem, xs, yt, w)))
    wall = time.perf_counter() - t0
    trace.append((wall, total_epochs, _objective(problem, xs, yt, w)))
    return AsyncResult(w=unpack_vec(w[:, :, 0], layout).astype(np.float64),
                       wall_time=wall, updates=iters * q, loss_trace=trace,
                       epochs=total_epochs, iterations=iters)
