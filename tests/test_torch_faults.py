"""The port's fault traces, membership-aware aggregation, and faulted and
guarded linear epochs against the JAX package.

* ``FaultTrace.compile`` and ``random_trace`` give the reference's arrays
  and events; the illegal-event and dominator-availability errors;
* ``_alive_fingerprint`` equals the reference's int32 for q <= 30 and,
  with the int32 wrap-around, beyond;
* ``secure_psum_members`` and ``secure_psum_ring_members`` give the
  survivor sum over every alive pattern at q = 4 and 8 (a lone ring
  survivor's mask is exactly 0), the engine's membership aggregation
  lowers ``schedule_faithful`` two-tree to the psum form, and
  ``secure_aggregate_survivors`` gives the reference's numbers and
  transcript bit for bit under the same numpy generator;
* the six oracles against the JAX oracles at 1e-6 over two chained
  epochs (iterate, ring, counter, SAGA's table and average, telemetry);
* the six ``FusedEngine`` epochs against the JAX engine's on its own
  ``_batch_indices`` schedule over two chained epochs (``wq``, ``bufq``,
  the counter) at 1e-5 across ``off``/``two_tree``/``ring``, with
  ``finite``/``alive`` equal and ``pnorm``/``gnorm`` within 1e-4, as
  ``tests/test_guards.py`` pins them; unguarded, a NaN partial poisons the
  iterate in the JAX engine's coordinates, guarded it is quarantined, and
  a blowup shows in ``pnorm``;
* a faulted step calls ``ops.vfl_grad`` once forward and once backward;
* the runners against the port's oracle drivers at 1e-5 (a trace of the
  JAX package feeds them too), their checks, and kill-and-resume bit for
  bit (the guarded runner's telemetry included);
* the ``cuda``-marked test runs the six epochs on the card under
  ``torch.cuda.set_sync_debug_mode("error")`` against the CPU engine.

Sizes are those of ``tests/test_faults.py`` and ``tests/test_guards.py``:
n = 48, d = 12 over q = 4 parties with m = 2, batch 8 (6 steps an epoch),
τ = 2, two epochs.  JAX is imported inside module-scoped fixtures.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import (algorithms, engine, faults, losses,
                              secure_agg, trees)
from repro_torch.kernels import ops
from repro_torch.sharding.api import PartyMesh

D, Q, M, N = 12, 4, 2, 48
TAU, EPOCHS, BATCH, STEPS, LR = 2, 2, 8, 6, 0.3
SECURE = ("off", "two_tree", "ring")
ALGOS = ("sgd", "svrg", "saga")
KINDS = ("faulted", "guarded")

# a crash and its rejoin, a straggler, a dropped broadcast, a permanent
# dropout in the second epoch (tests/test_faults.py)
FAULTED = ((2, 3, "crash", 0, ""), (5, 3, "rejoin", 0, ""),
           (3, 1, "straggle", 1, ""), (4, 2, "drop_msg", 0, ""),
           (7, 2, "crash", 0, ""))
# every corrupt mode over membership churn: a NaN and an Inf partial, a
# straggler, a crash and rejoin, a blowup while a party is down
# (tests/test_guards.py)
GUARDED = ((1, 1, "corrupt", 0, "nan"), (3, 3, "corrupt", 0, "inf"),
           (4, 1, "straggle", 1, ""), (6, 2, "crash", 0, ""),
           (8, 0, "corrupt", 0, "blowup"), (9, 2, "rejoin", 0, ""))


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
    from repro.core import engine as jeng
    from repro.core import faults as jfaults
    from repro.core import losses as jloss
    from repro.core import secure_agg as jsec
    return types.SimpleNamespace(jax=jax, jnp=jnp, alg=jalg, eng=jeng,
                                 faults=jfaults, sec=jsec,
                                 prob=jloss.logistic_l2(1e-3),
                                 layout=jalg.PartyLayout.even(D, Q, M))


def _trace(events, pkg=faults):
    return pkg.FaultTrace(q=Q, steps=EPOCHS * STEPS, events=tuple(
        pkg.FaultEvent(s, p, kind, k=k, mode=mode)
        for s, p, kind, k, mode in events))


@pytest.fixture(scope="module")
def traces():
    return {"faulted": _trace(FAULTED), "guarded": _trace(GUARDED)}


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


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _health_pinned(got, want):
    """``tests/test_guards.py``'s pin of the telemetry."""
    got = [np.asarray(a) for a in got]
    want = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["faulted", "guarded", "random",
                                  "random_corrupt"])
def test_compile_matches_reference(jx, layout, name):
    if name.startswith("random"):
        kw = dict(rate=0.15, p_corrupt=0.1 if name == "random_corrupt"
                  else 0.0, seed=5)
        tr = faults.random_trace(layout, 40, **kw)
        jtr = jx.faults.random_trace(jx.layout, 40, **kw)
    else:
        events = FAULTED if name == "faulted" else GUARDED
        tr, jtr = _trace(events), _trace(events, jx.faults)
    got, want = tr.compile(M), jtr.compile(M)
    for a in ("fwd", "bwd", "extra"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
        assert getattr(got, a).dtype == getattr(want, a).dtype
    np.testing.assert_array_equal(got.codes(), want.codes())
    win, jwin = got.epoch(1, 5), want.epoch(1, 5)
    for a, b in zip(win.party_rows() + (win.corrupt_rows(),),
                    jwin.party_rows() + (jwin.corrupt_rows(),)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(win.coord_rows(layout, D),
                    jwin.coord_rows(jx.layout, D)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.max_extra() == want.max_extra()
    assert faults.FaultTrace(q=Q, steps=3).compile().codes().sum() == 0


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("kw", [dict(), dict(rate=0.2, max_down=5,
                                             max_straggle=3, p_drop=0.1,
                                             p_corrupt=0.1),
                                dict(p_corrupt=0.3,
                                     corrupt_modes=("nan", "blowup"))])
def test_random_trace_matches_reference(jx, layout, seed, kw):
    tr = faults.random_trace(layout, 60, seed=seed, **kw)
    jtr = jx.faults.random_trace(jx.layout, 60, seed=seed, **kw)
    assert (tr.q, tr.steps) == (jtr.q, jtr.steps)
    assert [(e.step, e.party, e.kind, e.k, e.mode) for e in tr.events] \
        == [(e.step, e.party, e.kind, e.k, e.mode) for e in jtr.events]
    assert not any(e.kind == "crash" and e.party == 0 for e in tr.events)
    assert faults.as_trace(jtr) == tr


@pytest.mark.parametrize("events,err", [
    (((1, 2, "crash", 0, ""), (3, 2, "crash", 0, "")), "crashed twice"),
    (((1, 2, "rejoin", 0, ""),), "rejoin of live"),
    (((1, 2, "crash", 0, ""), (2, 2, "straggle", 1, "")), "crashed party"),
    (((1, 2, "crash", 0, ""), (2, 2, "drop_msg", 0, "")), "crashed party"),
    (((1, 2, "crash", 0, ""), (2, 2, "corrupt", 0, "nan")),
     "crashed party"),
    (((1, 2, "corrupt", 0, "gamma-ray"),), "corrupt needs mode"),
    (((1, 2, "straggle", -1, ""),), "k >= 0"),
    (((1, 2, "fire", 0, ""),), "unknown fault kind"),
    (((1, 7, "crash", 0, ""),), "out of range"),
    (((99, 1, "crash", 0, ""),), "outside trace horizon"),
])
def test_illegal_events(jx, events, err):
    for pkg in (faults, jx.faults):
        with pytest.raises(ValueError, match=err):
            _trace(events, pkg).compile(M)


def test_availability_errors(jx):
    both = ((1, 0, "crash", 0, ""), (1, 1, "crash", 0, ""))
    every = tuple((1, p, "crash", 0, "") for p in range(Q))
    for pkg in (faults, jx.faults):
        with pytest.raises(ValueError, match="dominator availability"):
            _trace(both, pkg).compile(M)
        _trace(both, pkg).compile()       # only total survivorship
        with pytest.raises(ValueError, match="surviving party"):
            _trace(every, pkg).compile()


def test_apply_corruption_modes():
    z = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
    np.testing.assert_array_equal(faults.apply_corruption(z, 0), z)
    assert faults.apply_corruption(z, 1).isnan().all()
    assert faults.apply_corruption(z, 2).isposinf().all()
    assert torch.equal(faults.apply_corruption(z, 3),
                       faults.BLOWUP_FACTOR * z)
    per_row = faults.apply_corruption(z, torch.tensor([[2], [0]]))
    assert per_row[0].isposinf().all() and torch.equal(per_row[1], z[1])


# ---------------------------------------------------------------------------
# membership-aware aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [4, 8, 30, 31, 40, 64])
def test_alive_fingerprint_matches_reference(jx, q):
    rng = np.random.default_rng(q)
    for av in [np.ones(q, np.int32), np.zeros(q, np.int32)] \
            + [(rng.random(q) > 0.4).astype(np.int32) for _ in range(20)]:
        got = secure_agg._alive_fingerprint(torch.from_numpy(av))
        want = jx.sec._alive_fingerprint(jx.jnp.asarray(av))
        assert got.dtype == torch.int32
        assert int(got) == int(want), av


@pytest.mark.parametrize("q", [4, 8])
@pytest.mark.parametrize("form", ["members", "ring_members"])
def test_member_psums_cancel_over_every_alive_pattern(q, form):
    fn = getattr(secure_agg, f"secure_psum_{form}")
    z = torch.from_numpy(np.random.default_rng(q).standard_normal(
        (q, 7, 2)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    for bits in itertools.product((0.0, 1.0), repeat=q):
        alive = torch.tensor(bits)
        if not alive.any():
            continue
        seen = []
        got = fn(z, gen, alive, mask_scale=1.0, transcript=seen)
        want = (alive[:, None, None] * z).sum(0)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        dead = alive == 0
        assert not seen[0][dead].any()        # no value, no mask
        if form == "ring_members" and alive.sum() == 1:
            # a lone survivor's two ring rows coincide: δ = 0 exactly
            assert torch.equal(got, z[int(alive.argmax())])
        else:
            assert not torch.isclose(seen[0][~dead], z[~dead],
                                     atol=1e-3).all()


def test_agg_members_ignores_the_schedule_replay(ds, prob, layout):
    """Under membership ``schedule_faithful`` two-tree lowers to the psum
    form: the same masks give the same bits."""
    x, y = ds
    z = torch.randn(Q, 5)
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0])
    outs = []
    for faithful in (False, True):
        te = engine.FusedEngine(prob, x, y, layout, engine.EngineConfig(
            secure="two_tree", schedule_faithful=faithful), device="cpu")
        outs.append(te._agg_members(z, torch.Generator().manual_seed(5),
                                    alive))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], secure_agg.secure_psum_members(
        z, torch.Generator().manual_seed(5), alive))


@pytest.mark.parametrize("alive", [[1, 1, 1, 1, 1], [1, 1, 0, 1, 1],
                                   [0, 1, 0, 1, 1], [1, 0, 0, 0, 1],
                                   [0, 0, 1, 0, 0]])
@pytest.mark.parametrize("strict", [False, True])
def test_secure_aggregate_survivors_matches_reference(jx, alive, strict):
    parts = [np.random.default_rng(p).standard_normal(6) for p in range(5)]
    degraded = sum(alive) < 3
    results = []
    for fn in (secure_agg.secure_aggregate_survivors,
               jx.sec.secure_aggregate_survivors):
        rng = np.random.default_rng(1)
        if degraded and strict:
            with pytest.raises(RuntimeError, match="strict=True"):
                fn(parts, alive, rng, strict=True)
            continue
        with pytest.warns(RuntimeWarning, match="degraded") if degraded \
                else _no_warning():
            results.append(fn(parts, alive, rng, strict=strict))
    if results:
        (val, tr), (jval, jtr) = results
        np.testing.assert_array_equal(val, jval)
        assert [[t for t, _ in m] for m in tr.messages] \
            == [[t for t, _ in m] for m in jtr.messages]
        for m, jm in zip(tr.messages, jtr.messages):
            for (_, v), (_, jv) in zip(m, jm):
                np.testing.assert_array_equal(v, jv)
        want = sum(p for p, a in zip(parts, alive) if a)
        np.testing.assert_allclose(val, want, atol=1e-9)
    with pytest.raises(ValueError, match=">= 1 surviving"):
        secure_agg.secure_aggregate_survivors(parts, [0] * 5,
                                              np.random.default_rng(0))
    assert trees.survivor_tree_pair(5, [0, 2, 4])[2] == [0, 2, 4]


class _no_warning:
    def __enter__(self):
        import warnings
        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._w.__exit__(*exc)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def _start(layout, algo, x, y, prob):
    """A shared start: w0 and, per algorithm, the snapshot's full gradient
    or SAGA's table and average (port tensors)."""
    w0 = torch.from_numpy((0.1 * np.random.default_rng(60)
                           .standard_normal(D)).astype(np.float32))
    if algo == "svrg":
        return (w0, w0.clone(), algorithms.full_gradient(prob, w0, x, y))
    if algo == "saga":
        return (w0,) + algorithms.saga_init(prob, w0, x, y)
    return (w0,)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_oracles_match_jax(ds, layout, prob, traces, jx, kind, algo):
    """Two chained epochs of each oracle on the same schedules, the state
    carried between them."""
    x, y = (torch.from_numpy(a) for a in ds)
    sched = traces[kind].compile(M)
    dcoord = faults._base_delays(layout, TAU, sched, None, 1)[
        layout.party_of_coord(D)]
    mask = torch.from_numpy(layout.update_mask(D, False))
    own = faults._ownership(layout, D)
    head = _start(layout, algo, x, y, prob)
    jhead = tuple(jx.jnp.asarray(a.numpy()) for a in head)
    buf, t = torch.zeros(TAU + 1, D), 0
    jbuf, jt = jx.jnp.zeros((TAU + 1, D)), jx.jnp.zeros((), jx.jnp.int32)
    fn = getattr(faults, f"{kind}_{algo}_epoch")
    jfn = getattr(jx.faults, f"{kind}_{algo}_epoch")
    common = (LR, mask, dcoord)
    jcommon = (LR, jx.jnp.asarray(mask.numpy()), jx.jnp.asarray(dcoord))
    for ep in range(EPOCHS):
        idx = np.random.default_rng(ep).integers(0, N, (STEPS, BATCH))
        win = sched.epoch(ep, STEPS)
        fc, bc, ec = win.coord_rows(layout, D)
        rows = (idx, fc, bc, ec) if kind == "faulted" \
            else (own, idx, win.fwd, bc, ec, win.codes())
        kw = {} if kind == "faulted" else {"guard": True}
        out = fn(prob, *head, buf, t, x, y, *common,
                 *(torch.as_tensor(r) for r in rows), **kw)
        jout = jfn(jx.prob, *jhead, jbuf, jt, *ds, *jcommon,
                   *(jx.jnp.asarray(np.asarray(r)) for r in rows), TAU,
                   *((True,) if kind == "guarded" else ()))
        if kind == "guarded":
            _health_pinned(out[-1], jout[-1])
            np.testing.assert_array_equal(np.asarray(out[-1].finite),
                                          np.asarray(jout[-1].finite))
            out, jout = out[:-1], jout[:-1]
        for a, b in zip(out[:-1], jout[:-1]):
            _close(a, b, 1e-6)
        assert int(out[-1]) == int(jout[-1]) == (ep + 1) * STEPS
        head = out[:1] + head[1:3] if algo == "svrg" else out[:-2]
        jhead = jout[:1] + jhead[1:3] if algo == "svrg" else jout[:-2]
        buf, t, jbuf, jt = out[-2], out[-1], jout[-2], jout[-1]
    assert torch.isfinite(out[0]).all()


# ---------------------------------------------------------------------------
# the engine's epochs
# ---------------------------------------------------------------------------

def _engine_inputs(layout, sched, ep, kind):
    win = sched.epoch(ep, STEPS)
    rows = list(win.party_rows())
    if kind == "guarded":
        rows.append(win.corrupt_rows())
    return rows


def _engine_runs(engines, layout, jx, traces, kind, algo, mode,
                 guard=True):
    """Two chained epochs of one faulted or guarded kind on both engines,
    on the JAX engine's schedules; yields (port out, JAX out) per epoch."""
    je, te = engines(mode)
    sched = traces[kind].compile(M)
    delays = faults._base_delays(layout, TAU, sched, None, 1)
    jwq = je.pack_w((0.1 * np.random.default_rng(70).standard_normal(D))
                    .astype(np.float32))
    twq = torch.from_numpy(np.array(jwq))
    jstate, tstate = (jwq,), (twq,)
    if algo == "saga":
        jtab, javg = je.saga_init(jwq, jx.jax.random.PRNGKey(0))
        jstate += (jtab, javg)
        tstate += (torch.from_numpy(np.array(jtab)),
                   torch.from_numpy(np.array(javg)))
    jbuf = jx.jnp.zeros((Q, TAU + 1, te.dp))
    tbuf = torch.zeros((Q, TAU + 1, te.dp))
    jt, tt = jx.jnp.zeros((), jx.jnp.int32), 0
    name = f"{kind}_{algo}_epoch"
    kw = {} if kind == "faulted" else {"guard": guard}
    for ep, k in enumerate((71, 72)):
        key = jx.jax.random.PRNGKey(k)
        idx = np.array(jx.alg._batch_indices(key, N, BATCH, STEPS))
        rows = _engine_inputs(layout, sched, ep, kind)
        jhead, thead = jstate, tstate
        if algo == "svrg":
            jhead = (jstate[0], jstate[0], je.full_gradient(jstate[0], key))
            thead = (tstate[0], tstate[0],
                     te.full_gradient(tstate[0], (k,)))
        jout = getattr(je, name)(*jhead, jbuf, jt, jx.jnp.asarray(delays),
                                 *(jx.jnp.asarray(r) for r in rows), LR,
                                 key, BATCH, STEPS, TAU, **kw)
        tout = getattr(te, name)(*thead, tbuf, tt, delays, *rows, LR,
                                 torch.from_numpy(idx), TAU, (k,), **kw)
        yield tout, jout
        n_state = 3 if algo == "saga" else 1
        jstate, tstate = jout[:n_state], tout[:n_state]
        jbuf, jt = jout[n_state], jout[n_state + 1]
        tbuf, tt = tout[n_state], tout[n_state + 1]


@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_engine_epochs_match_jax(engines, layout, jx, traces, kind, algo,
                                 mode):
    """``wq``, ``bufq`` and the counter at 1e-5, the telemetry pinned,
    over two chained epochs.  SAGA's ``tabq`` and ``avgq`` are held at
    1e-5 too where no mask residue enters them (``off``): under masks the
    ×10³ blowup's aggregate carries f32 mask rounding of that scale into
    the step's ϑ̃ entries."""
    for ep, (tout, jout) in enumerate(_engine_runs(
            engines, layout, jx, traces, kind, algo, mode)):
        if kind == "guarded":
            _health_pinned(tout[-1], jout[-1])
            assert not (np.asarray(tout[-1].finite) == 0).all()
            tout, jout = tout[:-1], jout[:-1]
        held = [0, -2] if mode != "off" else range(len(tout) - 1)
        for i in held:
            _close(tout[i], jout[i], 1e-5)
        assert tout[-1].dtype == torch.int64
        assert int(tout[-1]) == int(jout[-1]) == (ep + 1) * STEPS
        assert torch.isfinite(tout[0]).all()


@pytest.mark.parametrize("algo", ALGOS)
def test_unguarded_nan_poisons_like_the_reference(engines, layout, jx,
                                                  traces, algo):
    """``guard=False``: the step-1 NaN partial poisons the iterate in the
    JAX engine's coordinates (the ring too); the telemetry still records
    the corruption, and the blowup's partial shows in ``pnorm``."""
    for tout, jout in _engine_runs(engines, layout, jx, traces, "guarded",
                                   algo, "two_tree", guard=False):
        for a, b in zip(tout[:-2], jout[:-2]):
            np.testing.assert_array_equal(np.isnan(np.asarray(a)),
                                          np.isnan(np.asarray(b)))
        assert tout[0].isnan().any()
        _health_pinned(tout[-1], jout[-1])
    health = tout[-1]
    finite = np.asarray(health.finite)
    alive = np.asarray(health.alive)
    assert ((finite == 0) & (alive > 0)).any()   # entered the aggregate


def test_guard_quarantines_and_shows_the_blowup(engines, layout, jx,
                                                traces):
    """``guard=True``: the NaN and Inf partials leave the alive set (the
    iterate stays finite), the ×10³ blowup passes and shows in ``pnorm``."""
    outs = [t for t, _ in _engine_runs(engines, layout, jx, traces,
                                       "guarded", "sgd", "ring")]
    health = faults.HealthStats.concat([o[-1] for o in outs])
    assert health.finite[1, 1] == 0 and health.alive[1, 1] == 0
    assert health.finite[3, 3] == 0 and health.alive[3, 3] == 0
    assert health.alive[2, 6:9].sum() == 0            # crashed
    assert health.finite[0, 8] == 1 and health.alive[0, 8] == 1
    assert health.pnorm[0, 8] > 100 * np.median(health.pnorm[0])
    assert np.isfinite(health.gnorm).all()
    assert torch.isfinite(outs[-1][0]).all()


def test_faulted_step_kernel_calls(engines, layout, traces, monkeypatch):
    """A faulted step calls ``ops.vfl_grad`` once forward and once
    backward (the kernel carries the path); SVRG's iterate and snapshot
    ride both calls (M = 2)."""
    te = engines("ring")[1]
    sched = traces["guarded"].compile(M)
    calls = []
    real = ops.vfl_grad

    def counting(*args, **kw):
        calls.append((kw.get("mode", "forward"), tuple(args[1].shape)
                      if args[1] is not None else None))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "vfl_grad", counting)
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    wq = te.pack_w(np.zeros(D, np.float32))
    te.guarded_svrg_epoch(wq, wq, torch.zeros_like(wq),
                          torch.zeros(Q, TAU + 1, te.dp), 0,
                          np.zeros(Q, np.int32),
                          *_engine_inputs(layout, sched, 0, "guarded"), LR,
                          idx, TAU)
    assert calls == [("forward", (Q, te.dp, 2)), ("backward", None)] * STEPS


def test_epoch_argument_checks(engines, layout, traces):
    te = engines("off")[1]
    rows = _engine_inputs(layout, traces["faulted"].compile(M), 0,
                          "faulted")
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    wq = te.pack_w(np.zeros(D, np.float32))
    with pytest.raises(ValueError, match="tau=1 needs 2"):
        te.faulted_sgd_epoch(wq, torch.zeros(Q, TAU + 1, te.dp), 0,
                             np.zeros(Q, np.int32), *rows, LR, idx, 1)
    with pytest.raises(ValueError, match="fault channels"):
        te.faulted_sgd_epoch(wq, torch.zeros(Q, TAU + 1, te.dp), 0,
                             np.zeros(Q, np.int32), *rows, LR, idx[:4], TAU)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", KINDS)
def test_runners_match_oracle_drivers(ds, layout, prob, traces, jx, kind,
                                      algo):
    """The fused runner against the oracle driver on the same start,
    schedules and delays (the trace is the JAX package's own object)."""
    x, y = ds
    jtrace = _trace(FAULTED if kind == "faulted" else GUARDED, jx.faults)
    kw = dict(tau=TAU, epochs=EPOCHS, lr=LR, batch=BATCH, algo=algo,
              seed=1, device="cpu")
    fused = getattr(faults, f"run_{kind}_fused")(
        prob, x, y, layout, jtrace, engine_config=engine.EngineConfig(
            secure="ring"), **kw)
    ref = getattr(faults, f"run_{kind}_reference")(prob, x, y, layout,
                                                   jtrace, **kw)
    if kind == "guarded":
        _health_pinned(fused[1], ref[1])
        assert fused[1].finite.shape == (Q, EPOCHS * STEPS)
        fused, ref = fused[0], ref[0]
    _close(fused, ref, 1e-5)


def test_runner_checks(ds, layout, prob, traces):
    x, y = ds
    kw = dict(tau=TAU, epochs=EPOCHS, lr=LR, batch=BATCH, device="cpu")
    tr = traces["faulted"]
    with pytest.raises(ValueError, match="delay budget"):
        faults.run_faulted_fused(prob, x, y, layout, tr,
                                 delays_q=[0, TAU, 0, 0], **kw)
    with pytest.raises(ValueError, match="trace horizon"):
        faults.run_faulted_fused(prob, x, y, layout, tr.with_steps(5), **kw)
    with pytest.raises(ValueError, match="trace horizon"):
        faults.run_guarded_reference(prob, x, y, layout, tr,
                                     **dict(kw, epochs=1))
    # mesh= takes a PartyMesh; anything else is refused, and so is a
    # PartyMesh over anything but a torch.distributed DeviceMesh (on a
    # real device mesh these runners run across the ranks,
    # tests/test_torch_dist_faults.py)
    with pytest.raises(TypeError, match="PartyMesh"):
        faults.run_guarded_fused(prob, x, y, layout, tr, mesh=object(),
                                 **kw)
    with pytest.raises(TypeError, match="DeviceMesh"):
        faults.run_guarded_fused(prob, x, y, layout, tr,
                                 mesh=PartyMesh(q=Q, slots=2, mesh=object()),
                                 **kw)
    with pytest.raises(ValueError, match="unknown algo"):
        faults.run_faulted_reference(prob, x, y, layout, tr, algo="adam",
                                     **kw)
    for name in ("run_deep_faulted_reference", "run_deep_faulted_fused",
                 "run_deep_guarded_reference", "run_deep_guarded_fused"):
        with pytest.raises(ValueError, match="supports sgd/svrg"):
            getattr(faults, name)(prob, x, y, layout, tr, algo="saga", **kw)
        with pytest.raises(ValueError, match="trace horizon"):
            getattr(faults, name)(prob, x, y, layout, tr.with_steps(5),
                                  **kw)


def test_empty_trace_is_the_delayed_runner(ds, layout, prob):
    """No faults and zero base delays: the faulted runner is the τ = 0
    bounded-delay runner (the fault layer extends it, not forks it)."""
    from repro_torch.core import staleness
    x, y = ds
    kw = dict(epochs=EPOCHS, lr=LR, batch=BATCH, seed=3, device="cpu")
    w_f = faults.run_faulted_fused(prob, x, y, layout,
                                   faults.FaultTrace(Q, EPOCHS * STEPS),
                                   tau=TAU, delays_q=np.zeros(Q, np.int32),
                                   **kw)
    w_d = staleness.run_delayed_fused(prob, x, y, layout, 0, **kw)
    _close(w_f, w_d, 1e-6)


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
                             seed=9)
    run = getattr(faults, f"run_{kind}_fused")
    kw = dict(tau=TAU, epochs=epochs, lr=LR, batch=BATCH, algo=algo, seed=1,
              device="cpu", engine_config=engine.EngineConfig(
                  secure="two_tree"))
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
    res = run(prob, x, y, layout, tr, resume_from=ck, **kw)
    if kind == "guarded":
        for a, b in zip(res[1], full[1]):
            assert np.array_equal(a, b, equal_nan=True)
        res, full = res[0], full[0]
    assert np.array_equal(res, full)


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
def test_cuda_faulted_epochs_match_cpu_without_a_sync(cuda_device, ds,
                                                      layout, prob, traces,
                                                      mode):
    """On the card each faulted and guarded epoch is an eager step and
    replays of one captured step: it runs under
    ``set_sync_debug_mode("error")``, each captured step launches one
    narrow forward and one rows backward, and the results (telemetry
    included) equal the CPU engine's; a second run replays the first bit
    for bit."""
    from repro_torch.kernels import vfl_grad as vg
    x, y = ds
    cfg = engine.EngineConfig(secure=mode)
    ec = engine.FusedEngine(prob, x, y, layout, cfg, device="cpu")
    eg = engine.FusedEngine(prob, x, y, layout, cfg, device=cuda_device)
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    wq = ec.pack_w(0.1 * np.random.default_rng(0).standard_normal(D))
    tab, avg = ec.saga_init(wq)
    delays = torch.from_numpy(faults._base_delays(
        layout, TAU, traces["guarded"].compile(M), None, 1)).long()
    inputs = {}
    for kind in KINDS:
        rows = [torch.from_numpy(r) for r in _engine_inputs(
            layout, traces[kind].compile(M), 0, kind)]
        for algo in ALGOS:
            head = {"sgd": (wq,), "svrg": (wq, wq, torch.zeros_like(wq)),
                    "saga": (wq, tab, avg)}[algo]
            inputs[kind, algo] = (head, torch.zeros(Q, TAU + 1, ec.dp),
                                  delays, rows, idx)

    def run(eng, ins):
        out = {}
        for i, ((kind, algo), (head, buf, dl, rows, ix)) in \
                enumerate(ins.items()):
            out[kind, algo] = getattr(eng, f"{kind}_{algo}_epoch")(
                *head, buf, 0, dl, *rows, LR, ix, TAU, (i,))
        return out

    ginputs = {k: (tuple(a.to(cuda_device) for a in head),
                   buf.to(cuda_device), dl.to(cuda_device),
                   [r.to(cuda_device) for r in rows], ix.to(cuda_device))
               for k, (head, buf, dl, rows, ix) in inputs.items()}
    for _ in range(2):                    # capture, then reuse the graphs
        vg.KERNEL.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(eg, ginputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert vg.KERNEL.launches["vfl_forward_narrow"] == 6 * STEPS
        assert vg.KERNEL.launches["vfl_backward_rows"] == 6 * STEPS
    for (name, _), loop in eg._loops.items():
        assert loop.per_step == {"vfl_forward_narrow": 1,
                                 "vfl_backward_rows": 1}, name
    again = run(eg, ginputs)
    want = run(ec, inputs)
    for key in inputs:
        flat = [a for a in got[key] if isinstance(a, torch.Tensor)]
        flat += list(got[key][-1]) if key[0] == "guarded" else []
        flat2 = [a for a in again[key] if isinstance(a, torch.Tensor)]
        flat2 += list(again[key][-1]) if key[0] == "guarded" else []
        assert all(torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
                   and torch.equal(a.isnan(), b.isnan())
                   for a, b in zip(flat, flat2))
        n_state = 3 if key[1] == "saga" else 1
        held = range(n_state + 1) if mode == "off" else (0, n_state)
        for i in held:           # wq, bufq (off: SAGA's table, average)
            torch.testing.assert_close(got[key][i].cpu(), want[key][i],
                                       atol=1e-5, rtol=0)
        assert int(got[key][n_state + 1]) == STEPS
        if key[0] == "guarded":
            _health_pinned([a.cpu() for a in got[key][-1]], want[key][-1])
