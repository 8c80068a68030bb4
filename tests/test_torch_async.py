"""The port's BAPA thread simulation (``core/async_engine.py``) against the
JAX package's.

* ``TransportKnobs`` and ``ThreadFaultPlan`` validation: the reference's
  errors and messages;
* ``_sanitize_events`` on the same raw events gives the reference's
  (kind, party, step) tuples;
* ``run_sync`` against the reference's on the same seed: the iterate
  within 1e-5 relative, ``epochs`` and ``updates`` equal, the last probe's
  objective within 1e-5, and within 1e-6 of the port's ``sgd_epoch`` on
  the schedule the run drew;
* ``run_async``: the objective falls; the wall-clock bound is loud; a
  completed run reports about one epoch; the shared store loses no
  update under more writer threads than cores; a crash freezes the block, a
  rejoin is recorded; the realized trace compiles here and, event for
  event, in the reference's ``FaultTrace`` to the same dense slabs, and
  replays on ``run_faulted_fused``; fewer than 3 survivors warn
  "degraded"; a thread's or a launcher job's exception reaches the
  caller;
* the reference's straggler test (marked ``slow``, as the reference's
  is): ``run_async`` within 1.2x ``run_sync``'s wall time, on the CPU and
  on the card;
* the ``cuda``-marked test holds the launch counts to the rule in the
  module's docstring, exactly.

Sizes are the reference's tests': 600 samples (480 for training) of 24
features over q = 4 parties, m = 2, at most 2 epochs, ``base_delay``
≤ 1e-3 and ``max_wall`` ≤ 5 s (the straggler test: the reference's 3
epochs at 2e-3).  JAX is imported inside module-scoped
fixtures.  ``run_async`` sets the interpreter's switch interval as the
reference does; the module puts it back when it ends.
"""
import dataclasses
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, async_engine, faults, losses
from repro_torch.core.async_engine import (ThreadFaultPlan, TransportKnobs,
                                           run_async, run_sync)
from repro_torch.data.synthetic import classification_dataset

D, Q, M = 24, 4, 2
LR, DELAY, WALL = 0.2, 1e-3, 5.0
PROB = losses.logistic_l2(1e-3)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _switch_interval():
    before = sys.getswitchinterval()
    yield
    sys.setswitchinterval(before)


@pytest.fixture(scope="module")
def ds():
    d = classification_dataset("af", 600, D, seed=3, noise=0.4)
    return d.x_train, d.y_train


@pytest.fixture(scope="module")
def layout():
    return algorithms.PartyLayout.even(D, Q, M)


@pytest.fixture(scope="module")
def jx():
    from repro.core import algorithms as jalg
    from repro.core import async_engine as jae
    from repro.core import faults as jfaults
    from repro.core import losses as jloss
    return types.SimpleNamespace(ae=jae, faults=jfaults,
                                 prob=jloss.logistic_l2(1e-3),
                                 layout=jalg.PartyLayout.even(D, Q, M))


def _raises_alike(port_fn, ref_fn):
    with pytest.raises(ValueError) as want:
        ref_fn()
    with pytest.raises(ValueError) as got:
        port_fn()
    assert str(got.value) == str(want.value)


# -- validation ---------------------------------------------------------------

@pytest.mark.parametrize("field", ["put_timeout", "get_timeout",
                                   "crashed_poll", "frozen_poll"])
@pytest.mark.parametrize("value", [0.0, -1.0])
def test_transport_knobs_validation(jx, field, value):
    TransportKnobs().validate()
    _raises_alike(lambda: TransportKnobs(**{field: value}).validate(),
                  lambda: jx.ae.TransportKnobs(**{field: value}).validate())


PLANS = {
    "outside": dict(crash_at={Q: 5}),
    "without": dict(rejoin_at={1: 5}),
    "rejoin_count": dict(crash_at={1: 9}, rejoin_at={1: 4}),
    "every_active": dict(crash_at={0: 4, 1: 6}),
    "negative_party": dict(crash_at={-1: 3}),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plan_validate_errors(jx, layout, plan):
    kw = PLANS[plan]
    _raises_alike(lambda: ThreadFaultPlan(**kw).validate(layout),
                  lambda: jx.ae.ThreadFaultPlan(**kw).validate(jx.layout))


def test_plan_validate_accepts_a_legal_plan(jx, layout):
    kw = dict(crash_at={1: 4, 3: 8}, rejoin_at={1: 12})
    ThreadFaultPlan(**kw).validate(layout)
    jx.ae.ThreadFaultPlan(**kw).validate(jx.layout)


def _events(ev):
    return [(e.kind, e.party, e.step) for e in ev]


RAW = {
    "reference_case": ([("drop_msg", 1, 3), ("crash", 1, 3),
                        ("rejoin", 1, 5), ("rejoin", 2, 4),
                        ("crash", 0, 99)], 3, 8),
    # parties 1..3 only: party 0 stays up, so the trace compiles
    "random": ([(("crash", "rejoin", "drop_msg")[k], int(p), int(s))
                for k, p, s in zip(
                    np.random.default_rng(5).integers(0, 3, 60),
                    np.random.default_rng(6).integers(1, 4, 60),
                    np.random.default_rng(7).integers(-3, 40, 60))], 4, 32),
}


@pytest.mark.parametrize("case", sorted(RAW))
def test_sanitize_events_match_reference(jx, case):
    raw, q, steps = RAW[case]
    got = async_engine._sanitize_events(raw, q=q, steps=steps)
    want = jx.ae._sanitize_events(raw, q=q, steps=steps)
    assert _events(got) == _events(want)
    assert all(isinstance(e, faults.FaultEvent) for e in got)
    faults.FaultTrace(q=q, steps=steps, events=got).compile()
    if case == "reference_case":
        assert _events(got) == [("crash", 1, 3), ("rejoin", 1, 5),
                                ("crash", 0, 7)]


# -- the synchronous run ------------------------------------------------------

def test_run_sync_matches_reference_and_sgd(jx, ds, layout):
    x, y = ds
    kw = dict(lr=LR, batch=16, total_epochs=2.0, base_delay=DELAY,
              speed_factors=[1, 1, 1, 1.4], seed=4)
    got = run_sync(PROB, x, y, layout, device=CPU, **kw)
    want = jx.ae.run_sync(jx.prob, x, y, jx.layout, **kw)
    assert np.linalg.norm(got.w - want.w) <= 1e-5 * np.linalg.norm(want.w)
    assert (got.epochs, got.updates) == (want.epochs, want.updates)
    assert len(got.loss_trace) == len(want.loss_trace)
    assert got.loss_trace[-1][1] == want.loss_trace[-1][1]
    assert got.loss_trace[-1][2] == pytest.approx(want.loss_trace[-1][2],
                                                  rel=1e-5)
    assert got.loss_trace[-1][2] < got.loss_trace[0][2]
    # run_sync is SGD on the schedule of its own draws
    n = x.shape[0]
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(np.stack(
        [rng.integers(0, n, size=16) for _ in range(got.updates // Q)]))
    w = algorithms.sgd_epoch(PROB, torch.zeros(D), torch.from_numpy(x),
                             torch.from_numpy(y), LR, torch.ones(D),
                             idx).numpy()
    assert np.linalg.norm(got.w - w) <= 1e-6 * np.linalg.norm(w)


# -- the asynchronous run -----------------------------------------------------

def test_shared_store_loses_no_update(layout):
    """More writer threads than cores, at a very short switch interval:
    every block add and every count lands."""
    shared = async_engine._Shared(6, layout, torch.device(CPU))
    threads, adds = 16, 200

    def writer(i):
        for _ in range(adds):
            shared.add_to_block(i % Q, torch.ones(1, 6, 1), alpha=0.5)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=writer, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(before)
    assert shared.update_count == threads * adds
    want = torch.full((Q, 6), 0.5 * adds * threads / Q)
    assert torch.equal(shared.w, want)


@pytest.mark.parametrize("secure", [True, False])
def test_async_training_decreases_loss(ds, layout, secure):
    x, y = ds
    knobs = TransportKnobs(put_timeout=0.02, get_timeout=0.02,
                           crashed_poll=0.002, frozen_poll=0.001)
    res = run_async(PROB, x, y, layout, lr=LR, batch=16, total_epochs=2.0,
                    threads_per_party=2, base_delay=DELAY, secure=secure,
                    max_wall=WALL, transport=knobs, device=CPU)
    assert not res.timed_out
    assert res.updates >= int(2.0 * x.shape[0] / 16) * Q
    assert np.all(np.isfinite(res.w)) and res.w.dtype == np.float64
    assert res.loss_trace[-1][2] < res.loss_trace[0][2]
    assert res.fault_trace is None


def test_timeout_is_loud_and_reports_realized_epochs(ds, layout):
    x, y = ds
    with pytest.warns(RuntimeWarning, match="wall-clock bound"):
        res = run_async(PROB, x, y, layout, lr=LR, batch=16,
                        total_epochs=500.0, base_delay=DELAY, secure=False,
                        max_wall=0.5, device=CPU)
    assert res.timed_out
    assert 0.0 <= res.epochs < 500.0


def test_completed_run_reports_epochs(ds, layout):
    x, y = ds
    res = run_async(PROB, x, y, layout, lr=LR, batch=32, total_epochs=1.0,
                    base_delay=DELAY, secure=False, max_wall=WALL,
                    device=CPU)
    assert not res.timed_out
    assert res.epochs == pytest.approx(1.0, abs=0.25)
    sync = run_sync(PROB, x, y, layout, lr=LR, batch=32, total_epochs=1.0,
                    base_delay=DELAY, device=CPU)
    assert sync.epochs == 1.0


def test_crash_freezes_block_and_records_trace(ds, layout):
    x, y = ds
    lo, hi = layout.bounds[3]
    res = run_async(PROB, x, y, layout, lr=LR, batch=32, total_epochs=2.0,
                    base_delay=DELAY, secure=True, max_wall=WALL,
                    fault_plan=ThreadFaultPlan(crash_at={3: 8}), device=CPU)
    assert ("crash", 3) in {(e.kind, e.party) for e in res.fault_trace.events}
    live = np.concatenate([res.w[:lo], res.w[hi:]])
    assert np.abs(res.w[lo:hi]).max() < np.abs(live).max()
    assert np.abs(live).max() > 0


def test_rejoin_trace_compiles_alike_and_replays(jx, ds, layout):
    x, y = ds
    plan = ThreadFaultPlan(crash_at={2: 6}, rejoin_at={2: 20})
    res = run_async(PROB, x, y, layout, lr=LR, batch=32, total_epochs=2.0,
                    base_delay=DELAY, seed=1, secure=True, max_wall=WALL,
                    fault_plan=plan, device=CPU)
    tr = res.fault_trace
    assert isinstance(tr, faults.FaultTrace)
    kinds = [(e.kind, e.party) for e in tr.events]
    assert ("crash", 2) in kinds and ("rejoin", 2) in kinds
    got = tr.compile(layout.m)
    jtr = jx.faults.FaultTrace(q=tr.q, steps=tr.steps, events=tuple(
        jx.faults.FaultEvent(e.step, e.party, e.kind, e.k, e.mode)
        for e in tr.events))
    want = jtr.compile(layout.m)
    for name in ("fwd", "bwd", "extra"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_array_equal(got.codes(), want.codes())
    steps = 2 * (x.shape[0] // 32)
    w = faults.run_faulted_fused(PROB, x, y, layout, tr.with_steps(steps),
                                 tau=2, epochs=2, lr=LR, batch=32, seed=1,
                                 device=CPU)
    assert np.all(np.isfinite(w)) and np.abs(w).max() > 0


def test_secure_survivor_aggregation_degrades_loudly(ds, layout):
    x, y = ds
    plan = ThreadFaultPlan(crash_at={1: 4, 2: 4, 3: 4})
    with pytest.warns(RuntimeWarning, match="degraded"):
        res = run_async(PROB, x, y, layout, lr=LR, batch=32,
                        total_epochs=1.0, base_delay=DELAY, seed=2,
                        secure=True, max_wall=WALL, fault_plan=plan,
                        device=CPU)
    assert np.all(np.isfinite(res.w))


def test_thread_exception_reaches_the_caller(ds, layout):
    x, y = ds

    def theta(agg, yb):
        raise ArithmeticError("dominator failed")

    bad = dataclasses.replace(PROB, theta=theta)
    with pytest.raises(ArithmeticError, match="dominator failed"):
        run_async(bad, x, y, layout, lr=LR, batch=16, total_epochs=1.0,
                  base_delay=DELAY, max_wall=WALL, device=CPU)


def test_launcher_exception_reaches_the_caller(ds, layout):
    """A job that fails on the launcher thread (here the objective probe)
    stops the run and reaches the caller."""
    x, y = ds

    def loss(agg, yb):
        raise ArithmeticError("probe failed")

    bad = dataclasses.replace(PROB, loss=loss)
    with pytest.raises(ArithmeticError, match="probe failed"):
        run_async(bad, x, y, layout, lr=LR, batch=16, total_epochs=1.0,
                  base_delay=DELAY, max_wall=WALL, device=CPU)


@pytest.mark.slow
@pytest.mark.parametrize("impl", [
    "reference", CPU, pytest.param("cuda", marks=pytest.mark.cuda)])
def test_async_faster_than_sync_with_straggler(request, impl):
    """The reference's test of the paper's Figs. 3/4 claim
    (``tests/test_async_engine.py``), on the reference itself and on the
    port on each device: with a 50% straggler the asynchronous run reaches
    the epoch budget in less wall time than the barrier-synchronous one,
    with the reference's margin, after one short warm-up run of each.
    Prints both wall times (``-s``)."""
    if impl == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    d = classification_dataset("as", 600, 24, seed=2, noise=0.4)
    kw = dict(lr=0.2, batch=16, total_epochs=3.0, base_delay=2e-3,
              speed_factors=[1.0, 1.0, 1.0, 1.5])
    if impl == "reference":
        jx = request.getfixturevalue("jx")
        from repro.core import losses as jloss
        ae, prob, layout = jx.ae, jloss.logistic_l2(), jx.layout
    else:
        ae, prob = async_engine, losses.logistic_l2()
        layout = algorithms.PartyLayout.even(24, 4, 2)
        kw["device"] = impl
    # first calls load libraries (and on the card build the kernel):
    # that is not the claim, so one short run of each comes first
    for run, extra in ((ae.run_async, dict(threads_per_party=2)),
                       (ae.run_sync, {})):
        run(prob, d.x_train, d.y_train, layout,
            **dict(kw, total_epochs=0.2), **extra)
    a = ae.run_async(prob, d.x_train, d.y_train, layout,
                     threads_per_party=2, **kw)
    s = ae.run_sync(prob, d.x_train, d.y_train, layout, **kw)
    print(f"straggler, {impl}: async {a.wall_time:.3f} s, sync "
          f"{s.wall_time:.3f} s, async / sync {a.wall_time / s.wall_time:.3f}")
    assert a.wall_time < s.wall_time * 1.2, (a.wall_time, s.wall_time)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_launch_counts_follow_the_rule(cuda_device, ds, layout):
    from repro_torch.kernels import vfl_grad as vg
    x, y = ds
    vg.KERNEL.reset_launches()
    res = run_sync(PROB, x, y, layout, lr=LR, batch=16, total_epochs=1.0,
                   base_delay=DELAY, device=cuda_device)
    iters, got = res.updates // Q, dict(vg.KERNEL.launches)
    assert got["vfl_forward_narrow"] == iters + len(res.loss_trace)
    assert got["vfl_backward_rows"] == iters
    assert sum(got.values()) == 2 * iters + len(res.loss_trace)
    cpu = run_sync(PROB, x, y, layout, lr=LR, batch=16, total_epochs=1.0,
                   base_delay=DELAY, device=CPU)
    assert np.linalg.norm(res.w - cpu.w) <= 1e-5 * np.linalg.norm(cpu.w)

    vg.KERNEL.reset_launches()
    res = run_async(PROB, x, y, layout, lr=LR, batch=16, total_epochs=2.0,
                    base_delay=DELAY, secure=True, max_wall=WALL,
                    device=cuda_device)
    got = dict(vg.KERNEL.launches)
    assert got["vfl_backward_rows"] == res.updates
    assert got["vfl_forward_narrow"] == res.iterations + len(res.loss_trace)
    assert res.iterations >= res.updates / Q
    assert sum(got.values()) == got["vfl_backward_rows"] \
        + got["vfl_forward_narrow"]
    assert res.loss_trace[-1][2] < res.loss_trace[0][2]
