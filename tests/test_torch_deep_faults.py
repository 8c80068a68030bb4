"""The port's deep faulted and guarded epochs, their oracles and runners,
and ``supervised_guarded_run(deep=True)`` against the JAX package.

* the four deep oracles (``faults.deep_{faulted,guarded}_{sgd,svrg}_epoch``)
  against the JAX oracles' steps at 1e-6 over two chained epochs
  (params, every ring slot, the counter, the telemetry), SVRG's μ̃
  against ``_deep_full_grad_ref``;
* the port's oracle drivers against the JAX drivers fed the same start
  and schedules;
* the four ``FusedEngine`` epochs against the JAX engine's on its own
  ``_batch_indices`` schedule over two chained epochs at 1e-5 across
  ``off``/``two_tree``/``ring`` (every leaf, every ring slot in the
  reference's per-leaf layout, the counter), the telemetry pinned as
  ``tests/test_guards.py`` pins it, on nan/inf traces;
* the ×10³ blowup trace (ROADMAP C.R1) at a relative tolerance;
* unguarded, a NaN partial poisons the params in the JAX engine's
  coordinates; guarded it is quarantined;
* the runners against the port's oracle drivers, their checks, and
  kill-and-resume bit for bit (telemetry included);
* ``supervised_guarded_run(deep=True)``;
* a deep faulted step's kernel calls (4, SVRG 6);
* the ``cuda``-marked test runs the four epochs on the card under
  ``torch.cuda.set_sync_debug_mode("error")`` against the CPU engine.

Sizes are those of ``tests/test_faults.py`` and ``tests/test_guards.py``:
n = 48, d = 12 over q = 4 parties with m = 2, batch 8 (6 steps an epoch),
τ = 2, two epochs, hidden 8, d_rep 6.  JAX is imported inside
module-scoped fixtures.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import (algorithms, deep_vfl, engine, faults, losses,
                              staleness, supervisor)
from repro_torch.kernels import ops

D, Q, M, N = 12, 4, 2, 48
TAU, EPOCHS, BATCH, STEPS, LR = 2, 2, 8, 6, 0.1
HID, DREP = 8, 6
SECURE = ("off", "two_tree", "ring")
ALGOS = ("sgd", "svrg")
KINDS = ("faulted", "guarded")

# a crash and its rejoin, a straggler, a dropped broadcast, a permanent
# dropout in the second epoch (tests/test_faults.py)
FAULTED = ((2, 3, "crash", 0, ""), (5, 3, "rejoin", 0, ""),
           (3, 1, "straggle", 1, ""), (4, 2, "drop_msg", 0, ""),
           (7, 2, "crash", 0, ""))
# tests/test_guards.py's trace with its ×10³ blowup made a NaN: the
# nan/inf-only trace the 1e-5 pins use (ROADMAP C.R1)
NANINF = ((1, 1, "corrupt", 0, "nan"), (3, 3, "corrupt", 0, "inf"),
          (4, 1, "straggle", 1, ""), (6, 2, "crash", 0, ""),
          (8, 0, "corrupt", 0, "nan"), (9, 2, "rejoin", 0, ""))
# tests/test_guards.py's trace as it is, blowup at step 8 included
BLOWUP = NANINF[:4] + ((8, 0, "corrupt", 0, "blowup"),) + NANINF[5:]


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = (rng.random(N) > 0.5).astype(np.float32) * 2 - 1
    return x, y


@pytest.fixture(scope="module")
def layout():
    return algorithms.PartyLayout.even(D, Q, M)


@pytest.fixture(scope="module")
def prob():
    return losses.logistic_l2(1e-3)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.core import algorithms as jalg
    from repro.core import deep_vfl as jdeep
    from repro.core import engine as jeng
    from repro.core import faults as jfaults
    from repro.core import losses as jloss
    return types.SimpleNamespace(jax=jax, jnp=jnp, alg=jalg, eng=jeng,
                                 deep=jdeep, faults=jfaults,
                                 prob=jloss.logistic_l2(1e-3),
                                 layout=jalg.PartyLayout.even(D, Q, M))


def _trace(events, pkg=faults, epochs=EPOCHS):
    return pkg.FaultTrace(q=Q, steps=epochs * STEPS, events=tuple(
        pkg.FaultEvent(s, p, kind, k=k, mode=mode)
        for s, p, kind, k, mode in events))


def _kind_trace(kind):
    return FAULTED if kind == "faulted" else NANINF


@pytest.fixture(scope="module")
def engines(ds, prob, layout, jx):
    """(JAX engine, port engine) per secure mode, built once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            x, y = ds
            cache[mode] = (
                jx.eng.FusedEngine(jx.prob, x, y, jx.layout,
                                   jx.eng.EngineConfig(secure=mode)),
                engine.FusedEngine(prob, x, y, layout,
                                   engine.EngineConfig(secure=mode),
                                   device="cpu"))
        return cache[mode]

    return get


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _health_pinned(got, want):
    """``tests/test_guards.py``'s pin of the telemetry."""
    got = [_np(a) for a in got]
    want = [_np(a) for a in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _leaves(p):
    """A ``DeepVFLParams`` of either package as a flat list of arrays."""
    return [_np(a) for a in (*p.enc_w1, *p.enc_b1, *p.enc_w2, p.head)]


def _pt(jparams):
    """The JAX package's ``DeepVFLParams`` as the port oracles' tuple."""
    return deep_vfl._to_tuple(deep_vfl.DeepVFLParams(
        *([np.asarray(a) for a in leaf] for leaf in
          (jparams.enc_w1, jparams.enc_b1, jparams.enc_w2)),
        np.asarray(jparams.head)), "cpu", torch.float32)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def _jax_oracle_epochs(jx, ds, layout, kind, algo, guard=True):
    """The JAX oracles' steps over two chained epochs from a shared start,
    on numpy schedules; yields (start pt, per epoch: (schedule, params,
    rings, counter, health, mu))."""
    x, y = ds
    jp = jx.deep.init_deep_vfl(jx.jax.random.PRNGKey(60), jx.layout, D, HID,
                               DREP)
    sched = _trace(_kind_trace(kind)).compile(M)
    delays = faults._base_delays(layout, TAU, sched, None, 1)
    xj = jx.jnp.asarray(x)
    yj = jx.jnp.asarray(y)
    blocks = [xj[:, lo:hi] for lo, hi in layout.bounds]
    w1, b1, w2, head = (list(jp.enc_w1), list(jp.enc_b1), list(jp.enc_w2),
                        jp.head)
    bufs = jx.faults._deep_ring_init(w1, b1, w2, TAU)
    out, t = [], 0
    for ep in range(EPOCHS):
        idx = np.random.default_rng(ep).integers(0, N, (STEPS, BATCH))
        win = sched.epoch(ep, STEPS)
        codes = win.codes()
        health = faults.HealthStats(*(np.zeros((Q, STEPS), np.float32)
                                      for _ in range(4)))
        mu = snap = None
        if algo == "svrg":
            snap = (list(w1), list(b1), list(w2), head)
            mu = jx.faults._deep_full_grad_ref(jx.prob, blocks, yj, *snap)
        for i in range(STEPS):
            rows = (win.fwd[i], win.bwd[i], win.extra[i])
            ib = jx.jnp.asarray(idx[i])
            if kind == "faulted":
                fn = getattr(jx.faults, f"_deep_fault_{algo}_step")
                args = rows + (TAU,)
            else:
                fn = getattr(jx.faults, f"_deep_guard_{algo}_step")
                args = rows + (codes[i], TAU, guard, health, i)
            pre = (snap, mu) if algo == "svrg" else ()
            w1, b1, w2, head, bufs = fn(jx.prob, blocks, yj, w1, b1, w2,
                                        head, *pre, bufs, t, ib, LR, delays,
                                        *args)
            t += 1
        out.append((idx, (list(w1), list(b1), list(w2), head),
                    [list(r) for r in zip(*bufs)], t, health, mu))
    return _pt(jp), delays, sched, out


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_oracles_match_jax(ds, layout, prob, jx, kind, algo):
    """Two chained epochs of each deep oracle against the JAX oracle's
    steps on the same schedules: params, every ring slot and the counter
    at 1e-6, the telemetry pinned, μ̃ at 1e-6."""
    pt, delays, sched, jout = _jax_oracle_epochs(jx, ds, layout, kind, algo)
    blocks = tuple(torch.from_numpy(ds[0][:, lo:hi])
                   for lo, hi in layout.bounds)
    y = torch.from_numpy(ds[1])
    rings, t = faults._deep_ring_init(pt, TAU), 0
    fn = getattr(faults, f"deep_{kind}_{algo}_epoch")
    for ep, (idx, jparams, jrings, jt, jhealth, jmu) in enumerate(jout):
        win = sched.epoch(ep, STEPS)
        head = (pt,)
        if algo == "svrg":
            mu = deep_vfl._bum_grads(pt, list(blocks), y, prob, Q)
            for a, b in zip(_flat(mu), _flat(jmu)):
                _close(a, b, 1e-6)
            head = (pt, pt, mu)
        rows = (win.fwd, win.bwd, win.extra) \
            + (() if kind == "faulted" else (win.codes(),))
        out = fn(prob, *head, rings, t, blocks, y, LR, delays,
                 torch.from_numpy(idx), *rows)
        pt, rings, t = out[:3]
        for a, b in zip(_flat(pt), _flat(jparams)):
            _close(a, b, 1e-6)
        for leaf, jleaf in zip(rings, jrings):
            for a, b in zip(leaf, jleaf):
                _close(a, b, 1e-6)
        assert t.dtype == torch.int64 and int(t) == jt == (ep + 1) * STEPS
        if kind == "guarded":
            _health_pinned(out[3], jhealth)
            assert (_np(out[3].finite) == 0).any()
    assert all(torch.isfinite(a).all() for a in _flat(pt))


def _flat(pt):
    """A parameter (or gradient) tuple of either package as a flat list."""
    out = []
    for leaf in pt:
        out.extend(leaf if isinstance(leaf, (list, tuple)) else [leaf])
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_oracle_drivers_match_jax(ds, layout, prob, jx, kind):
    """The port's drivers against the JAX drivers on the JAX start and
    schedules (``params=``, ``indices=``): SGD and SVRG at 1e-6, the
    telemetry pinned."""
    x, y = ds
    seed = 2
    key = jx.jax.random.PRNGKey(seed)
    jp = jx.deep.init_deep_vfl(key, jx.layout, D, HID, DREP)
    indices = []
    for _ in range(EPOCHS):
        key, sub = jx.jax.random.split(key)
        indices.append(np.asarray(jx.alg._batch_indices(sub, N, BATCH,
                                                        STEPS)))
    params = deep_vfl.DeepVFLParams(*([np.asarray(a) for a in leaf] for leaf
                                      in (jp.enc_w1, jp.enc_b1, jp.enc_w2)),
                                    np.asarray(jp.head))
    kw = dict(tau=TAU, epochs=EPOCHS, lr=LR, batch=BATCH, seed=seed,
              hidden=HID, d_rep=DREP)
    for algo in ALGOS:
        got = getattr(faults, f"run_deep_{kind}_reference")(
            prob, x, y, layout, _trace(_kind_trace(kind)), algo=algo,
            params=params, indices=indices, device="cpu", **kw)
        want = getattr(jx.faults, f"run_deep_{kind}_reference")(
            jx.prob, x, y, jx.layout, _trace(_kind_trace(kind), jx.faults),
            algo=algo, **kw)
        if kind == "guarded":
            _health_pinned(got[1], want[1])
            got, want = got[0], want[0]
        for a, b in zip(_leaves(got), _leaves(want)):
            _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# the engine's epochs
# ---------------------------------------------------------------------------

def _engine_runs(engines, layout, jx, kind, algo, mode, events=None,
                 guard=True):
    """Two chained epochs of one deep faulted or guarded kind on both
    engines from the same start, on the JAX engine's schedules; yields
    (port out, JAX out) per epoch."""
    je, te = engines(mode)
    sched = _trace(events or _kind_trace(kind)).compile(M)
    delays = faults._base_delays(layout, TAU, sched, None, 1)
    jpq = je.pack_deep(jx.deep.init_deep_vfl(jx.jax.random.PRNGKey(70),
                                             jx.layout, D, HID, DREP))
    tpq = tuple(torch.from_numpy(np.array(a)) for a in jpq)
    jbuf = je.deep_delay_buffers(jpq, TAU)
    tbuf = te.deep_delay_buffers(tpq, TAU)
    jt, tt = jx.jnp.zeros((), jx.jnp.int32), 0
    name = f"deep_{kind}_{algo}_epoch"
    kw = {} if kind == "faulted" else {"guard": guard}
    for ep, k in enumerate((71, 72)):
        key = jx.jax.random.PRNGKey(k)
        idx = np.array(jx.alg._batch_indices(key, N, BATCH, STEPS))
        win = sched.epoch(ep, STEPS)
        rows = list(win.party_rows())
        if kind == "guarded":
            rows.append(win.corrupt_rows())
        jhead, thead = (jpq,), (tpq,)
        if algo == "svrg":
            jhead = (jpq, jpq, je.deep_full_gradient(jpq, key))
            thead = (tpq, tpq, te.deep_full_gradient(tpq, (k,)))
        jout = getattr(je, name)(*jhead, jbuf, jt, jx.jnp.asarray(delays),
                                 *(jx.jnp.asarray(r) for r in rows), LR,
                                 key, BATCH, STEPS, TAU, **kw)
        tout = getattr(te, name)(*thead, tbuf, tt, delays, *rows, LR,
                                 torch.from_numpy(idx), TAU, (k,), **kw)
        yield tout, jout
        jpq, jbuf, jt = jout[:3]
        tpq, tbuf, tt = tout[:3]


def _state_close(tout, jout, atol):
    for a, b in zip(tout[0] + tout[1], tuple(jout[0]) + tuple(jout[1])):
        _close(a, b, atol)


@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_engine_epochs_match_jax(engines, layout, jx, kind, algo, mode):
    """Every leaf, every ring slot and the counter at 1e-5, the telemetry
    pinned, over two chained epochs on a nan/inf trace."""
    for ep, (tout, jout) in enumerate(_engine_runs(engines, layout, jx,
                                                   kind, algo, mode)):
        _state_close(tout, jout, 1e-5)
        assert tout[2].dtype == torch.int64
        assert int(tout[2]) == int(jout[2]) == (ep + 1) * STEPS
        if kind == "guarded":
            _health_pinned(tout[3], jout[3])
            assert not (_np(tout[3].finite) == 0).all()
        assert all(torch.isfinite(a).all() for a in tout[0])


@pytest.mark.parametrize("algo", ALGOS)
def test_blowup_trace_relative(engines, layout, jx, algo):
    """The ×10³ blowup trace (ROADMAP C.R1): a blown-up party's partial
    enters the aggregate at 10³ its scale, so the step's f32 rounding is
    10³ times larger and the reference's own fused epoch misses its
    oracle by up to 9.5e-5 abs.  Each leaf and ring is held within 1e-4
    of its norm (relative L2) of the JAX engine on the same schedule
    under ``off`` and ``ring``, the telemetry pinned and the blowup shown
    in ``pnorm``."""
    for mode in ("off", "ring"):
        for tout, jout in _engine_runs(engines, layout, jx, "guarded", algo,
                                       mode, events=BLOWUP):
            for a, b in zip(tout[0] + tout[1],
                            tuple(jout[0]) + tuple(jout[1])):
                a, b = _np(a), _np(b)
                assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
            _health_pinned(tout[3], jout[3])
    pnorm = _np(tout[3].pnorm)
    assert pnorm[0, 8 - STEPS] > 100 * np.median(pnorm[0])


@pytest.mark.parametrize("algo", ALGOS)
def test_unguarded_nan_poisons_like_the_reference(engines, layout, jx,
                                                  algo):
    """``guard=False``: the step-1 NaN partial poisons the params and the
    rings in the JAX engine's coordinates; the telemetry still records
    the corruption."""
    for tout, jout in _engine_runs(engines, layout, jx, "guarded", algo,
                                   "two_tree", guard=False):
        for a, b in zip(tout[0] + tout[1], tuple(jout[0]) + tuple(jout[1])):
            np.testing.assert_array_equal(np.isnan(_np(a)), np.isnan(_np(b)))
        assert tout[0][3].isnan().all()
        np.testing.assert_array_equal(_np(tout[3].finite),
                                      _np(jout[3].finite))
        np.testing.assert_array_equal(_np(tout[3].alive),
                                      _np(jout[3].alive))
    finite, alive = _np(tout[3].finite), _np(tout[3].alive)
    assert ((finite == 0) & (alive > 0)).any()   # entered the aggregate


def test_guard_quarantines(engines, layout, jx):
    """``guard=True``: the NaN and Inf partials leave the alive set and the
    params stay finite; a crashed party is not alive."""
    outs = [t for t, _ in _engine_runs(engines, layout, jx, "guarded", "sgd",
                                       "ring")]
    health = faults.HealthStats.concat([o[3] for o in outs])
    for step, party in ((1, 1), (3, 3), (8, 0)):
        assert health.finite[party, step] == 0
        assert health.alive[party, step] == 0
    assert health.alive[2, 6:9].sum() == 0
    assert np.isfinite(health.gnorm).all()
    assert not supervisor.poisoned_steps(health).any()
    assert all(torch.isfinite(a).all() for a in outs[-1][0])


@pytest.mark.parametrize("algo,launches", [("sgd", 4), ("svrg", 6)])
def test_step_kernel_calls(engines, layout, algo, launches, monkeypatch):
    """A deep faulted or guarded step calls ``ops.vfl_grad`` as a fresh
    deep step does: 4 times (SVRG 6: one layer-1 forward and one xᵀ∂u
    against both sides' columns)."""
    te = engines("ring")[1]
    calls = []
    real = ops.vfl_grad

    def counting(*args, **kw):
        calls.append(kw.get("mode", "forward"))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "vfl_grad", counting)
    sched = _trace(NANINF).compile(M)
    rows = list(sched.epoch(0, STEPS).party_rows())
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    pq = te.pack_deep(deep_vfl.initial_params(0, layout, D, HID, DREP))
    head = (pq,) if algo == "sgd" else (pq, pq, te.deep_full_gradient(pq))
    for kind in KINDS:
        calls.clear()
        extra = () if kind == "faulted" \
            else (sched.epoch(0, STEPS).corrupt_rows(),)
        getattr(te, f"deep_{kind}_{algo}_epoch")(
            *head, te.deep_delay_buffers(pq, TAU), 0, np.zeros(Q, np.int32),
            *rows, *extra, LR, idx, TAU)
        assert len(calls) == launches * STEPS
        assert calls.count("forward") == launches // 2 * STEPS


def test_epoch_argument_checks(engines, layout):
    te = engines("off")[1]
    rows = list(_trace(FAULTED).compile(M).epoch(0, STEPS).party_rows())
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    pq = te.pack_deep(deep_vfl.initial_params(0, layout, D, HID, DREP))
    with pytest.raises(ValueError, match="tau=1 needs 2"):
        te.deep_faulted_sgd_epoch(pq, te.deep_delay_buffers(pq, TAU), 0,
                                  np.zeros(Q, np.int32), *rows, LR, idx, 1)
    with pytest.raises(ValueError, match="fault channels"):
        te.deep_faulted_sgd_epoch(pq, te.deep_delay_buffers(pq, TAU), 0,
                                  np.zeros(Q, np.int32), *rows, LR, idx[:4],
                                  TAU)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

RUN_KW = dict(tau=TAU, epochs=EPOCHS, lr=LR, batch=BATCH, seed=1, hidden=HID,
              d_rep=DREP, device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_runners_match_oracle_drivers(ds, layout, prob, jx, kind, algo):
    """The fused runner against the oracle driver on the same start,
    schedules and delays (the trace is the JAX package's own object)."""
    x, y = ds
    jtrace = _trace(_kind_trace(kind), jx.faults)
    fused = getattr(faults, f"run_deep_{kind}_fused")(
        prob, x, y, layout, jtrace, algo=algo,
        engine_config=engine.EngineConfig(secure="ring"), **RUN_KW)
    ref = getattr(faults, f"run_deep_{kind}_reference")(
        prob, x, y, layout, jtrace, algo=algo, **RUN_KW)
    if kind == "guarded":
        _health_pinned(fused[1], ref[1])
        assert fused[1].finite.shape == (Q, EPOCHS * STEPS)
        fused, ref = fused[0], ref[0]
    for a, b in zip(_leaves(fused), _leaves(ref)):
        _close(a, b, 1e-5)


def test_runner_checks(ds, layout, prob):
    x, y = ds
    tr = _trace(FAULTED)
    for name in ("run_deep_faulted_reference", "run_deep_faulted_fused",
                 "run_deep_guarded_reference", "run_deep_guarded_fused"):
        run = getattr(faults, name)
        with pytest.raises(ValueError, match="supports sgd/svrg"):
            run(prob, x, y, layout, tr, algo="saga", **RUN_KW)
        with pytest.raises(ValueError, match="trace horizon"):
            run(prob, x, y, layout, tr.with_steps(5), **RUN_KW)
        with pytest.raises(ValueError, match="delay budget"):
            run(prob, x, y, layout, tr, delays_q=[0, TAU, 0, 0], **RUN_KW)


def test_empty_trace_is_the_delayed_runner(ds, layout, prob):
    """No faults and zero base delays: the deep faulted runner is the
    τ = 0 deep bounded-delay runner (the fault layer extends it)."""
    x, y = ds
    kw = {k: v for k, v in RUN_KW.items() if k != "tau"}
    p_f = faults.run_deep_faulted_fused(prob, x, y, layout,
                                        faults.FaultTrace(Q, EPOCHS * STEPS),
                                        tau=TAU,
                                        delays_q=np.zeros(Q, np.int32), **kw)
    p_d = staleness.run_deep_delayed_fused(prob, x, y, layout, 0, **kw)
    for a, b in zip(_leaves(p_f), _leaves(p_d)):
        _close(a, b, 1e-6)


class _Preempt(Exception):
    pass


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_kill_and_resume_bit_exact(ds, layout, prob, monkeypatch, tmp_path,
                                   kind, algo):
    x, y = ds
    epochs = 4
    tr = faults.random_trace(layout, epochs * STEPS, rate=0.1,
                             p_corrupt=0.1 if kind == "guarded" else 0.0,
                             corrupt_modes=("nan", "inf"), seed=9)
    run = getattr(faults, f"run_deep_{kind}_fused")
    kw = dict(RUN_KW, epochs=epochs, algo=algo,
              engine_config=engine.EngineConfig(secure="two_tree"))
    full = run(prob, x, y, layout, tr, **kw)
    ck = str(tmp_path / "ck")
    orig = ckpt.save_checkpoint

    def killer(path, tree, step=0, **kw_):
        orig(path, tree, step=step, **kw_)
        if step == 2:
            raise _Preempt()

    monkeypatch.setattr(ckpt, "save_checkpoint", killer)
    with pytest.raises(_Preempt):
        run(prob, x, y, layout, tr, checkpoint_dir=ck, **kw)
    monkeypatch.undo()
    with np.load(ckpt.latest_checkpoint(ck)) as bundle:  # the ring's layout
        assert int(bundle["['t0']"]) == 2 * STEPS
        assert bundle["['bufq'][0]"].shape == (Q, TAU + 1, D // Q, HID)
    res = run(prob, x, y, layout, tr, resume_from=ck, **kw)
    if kind == "guarded":
        for a, b in zip(res[1], full[1]):
            assert np.array_equal(a, b, equal_nan=True)
        res, full = res[0], full[0]
    for a, b in zip(_leaves(res), _leaves(full)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def test_supervised_guarded_run_deep(ds, layout, prob, tmp_path):
    """``deep=True`` supervises the deep guarded runner: a NaN partial that
    entered the aggregate under ``guard=False`` heals by turning the
    guard on, and the run finishes finite."""
    x, y = ds
    epochs = 3
    tr = _trace(((STEPS + 1, 1, "corrupt", 0, "nan"),), epochs=epochs)
    p, health, heals = supervisor.supervised_guarded_run(
        prob, x, y, layout, tr, TAU, epochs, LR, BATCH, algo="sgd", seed=1,
        guard=False, deep=True, hidden=HID, d_rep=DREP,
        checkpoint_dir=str(tmp_path / "deep"),
        config=supervisor.SupervisorConfig(keep_last=3), device="cpu")
    assert isinstance(p, deep_vfl.DeepVFLParams)
    assert heals and heals[0]["reason"] == "poisoned" and heals[0]["guard"]
    assert heals[0]["diverged_epoch"] == 2
    assert all(np.isfinite(a).all() for a in _leaves(p))
    assert not supervisor.poisoned_steps(health).any()
    assert health.finite[1, STEPS + 1] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SECURE)
def test_cuda_deep_faulted_epochs_match_cpu_without_a_sync(cuda_device, ds,
                                                           layout, prob,
                                                           mode):
    """On the card each deep faulted and guarded epoch is an eager step and
    replays of one captured step: it runs under
    ``set_sync_debug_mode("error")``, a captured step launches as a fresh
    deep step does (4; SVRG 6), the results (telemetry included) equal
    the CPU engine's, and a second run replays the first bit for bit."""
    from repro_torch.kernels import vfl_grad as vg
    x, y = ds
    cfg = engine.EngineConfig(secure=mode)
    ec = engine.FusedEngine(prob, x, y, layout, cfg, device="cpu")
    eg = engine.FusedEngine(prob, x, y, layout, cfg, device=cuda_device)
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    pq = ec.pack_deep(deep_vfl.initial_params(0, layout, D, HID, DREP))
    mu = ec.deep_full_gradient(pq)
    sched = _trace(NANINF).compile(M)
    delays = torch.from_numpy(faults._base_delays(layout, TAU, sched, None,
                                                  1)).long()
    win = sched.epoch(0, STEPS)
    rows = [torch.from_numpy(r) for r in win.party_rows()]
    codes = torch.from_numpy(win.corrupt_rows())
    bufq = ec.deep_delay_buffers(pq, TAU)

    def move(a, dev):
        return tuple(move(b, dev) for b in a) if isinstance(a, tuple) \
            else a.to(dev)

    def inputs(dev):
        """Each kind's arguments on ``dev``, staged before the epochs run
        (a host-to-device copy inside one would synchronise)."""
        return {(kind, algo): move(((pq,) if algo == "sgd" else (pq, pq, mu),
                                    bufq, delays, tuple(rows),
                                    () if kind == "faulted" else (codes,),
                                    idx), dev)
                for kind in KINDS for algo in ALGOS}

    ins = {"cpu": inputs("cpu"), "cuda": inputs(cuda_device)}

    def run(eng, dev):
        out = {}
        for i, (key, (head, buf, dl, rw, extra, ix)) in enumerate(
                ins[dev].items()):
            out[key] = getattr(eng, "deep_{}_{}_epoch".format(*key))(
                *head, buf, 0, dl, *rw, *extra, LR, ix, TAU, (i,))
        return out

    def flat(out):
        return [a for part in out for a in
                (part if isinstance(part, tuple) else (part,))]

    for _ in range(2):                    # capture, then reuse the graphs
        vg.KERNEL.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(eg, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert sum(vg.KERNEL.launches.values()) == 2 * (4 + 6) * STEPS
    for (name, _), loop in eg._loops.items():
        n = 6 if "svrg" in name else 4
        assert sum(loop.per_step.values()) == n, name
    again = run(eg, "cuda")
    want = run(ec, "cpu")
    for key in want:
        for a, b in zip(flat(got[key]), flat(again[key])):
            assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
        for a, b in zip(got[key][0] + got[key][1],
                        want[key][0] + want[key][1]):
            torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
        assert int(got[key][2]) == STEPS
        if key[0] == "guarded":
            _health_pinned(got[key][3], want[key][3])
