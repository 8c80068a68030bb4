"""Serving over a ``PartyMesh``: the port's ``ServeEngine`` on a packed engine
against the JAX ``ServeEngine`` on the JAX engine's ``PartyMesh`` emulation.

* port vs reference over ``PartyMesh(q=8, slots=4)`` and ``PartyMesh(q=8,
  slots=2, data_shards=2)`` under ``off``/``two_tree``/``ring``: one
  scripted trace (linear cold → hit → ``set_weights`` → delta → full →
  hit, then ``set_deep_params`` → deep cold → hit → new params → deep
  cold) gives predictions within 1e-5 and ``ServeStats`` equal field for
  field after every step.  The reference serves an engine with a data
  axis (its programs run replicated over the axis); the port serves it
  too and ignores the axis;
* within the port: packed ``off`` is flat serving bit for bit; with a
  data axis, every mode serves the bits of the same mesh without one;
  a packed hit replays its cold dispatch bit for bit; a ``ServeQueue``
  over a packed engine answers concurrent submits as ``serve`` does.

Sizes: n = 64, d = 32 over q = 8 parties with m = 2 (``tests/
test_torch_mesh.py``'s), ``max_batch`` 8, deep hidden 4, d_rep 3.  JAX is
imported inside module-scoped fixtures, and each JAX trace runs once.
"""
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, deep_vfl, engine, losses
from repro_torch.serve import ServeEngine, ServeQueue
from repro_torch.sharding.api import PartyMesh

N, D, Q, M = 64, 32, 8, 2
HID, DREP, BATCH = 4, 3, 8
SECURE = ("off", "two_tree", "ring")
SHAPES = ((8, 4), (8, 2, 2))               # (q, slots[, data_shards])
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def _mesh_kw(shape):
    return dict(q=shape[0], slots=shape[1],
                data_shards=shape[2] if len(shape) > 2 else 1)


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N, D)).astype(np.float32) / np.sqrt(D)
    y = np.where(rng.standard_normal(N) > 0, 1.0, -1.0).astype(np.float32)
    w0 = rng.standard_normal(D).astype(np.float32)
    w1 = w0 + 0.05 * rng.standard_normal(D).astype(np.float32)
    layout = algorithms.PartyLayout.even(D, Q, M)
    deep = [deep_vfl.init_deep_vfl(torch.Generator().manual_seed(s), layout,
                                   D, HID, DREP) for s in (9, 10)]
    return types.SimpleNamespace(x=x, y=y, w0=w0, w1=w1, deep=deep,
                                 layout=layout)


# the trace: (action, argument); serve steps are recorded
SCRIPT = (("weights", "w0"), ("serve", [5, 1, 40, 5, 63, 0, 17, 9, 33, 2]),
          ("serve", [5, 40, 0]),
          ("weights", "w1"), ("serve", [5, 40, 9, 5]),
          ("serve", [5, 50, 11]), ("serve", [50, 5]),
          ("deep", 0), ("serve", [2, 2, 9, 33, 61]), ("serve", [33, 2]),
          ("deep", 1), ("serve", [2, 7]))
ROUTES = ("full", "hit", "delta", "full", "hit", "full", "hit", "full")


def _play(sv, weights, deep):
    """Run SCRIPT on ``sv``; returns [(predictions, stats dict)] per serve
    step."""
    out = []
    for act, arg in SCRIPT:
        if act == "weights":
            sv.set_weights(weights[arg])
        elif act == "deep":
            sv.set_deep_params(deep[arg])
        else:
            preds = sv.serve(np.asarray(arg))
            out.append((preds, dataclasses.asdict(sv.stats)))
    return out


def _port(ds, mode, shape=(), **kw):
    mesh = PartyMesh(**_mesh_kw(shape)) if shape else None
    eng = engine.FusedEngine(losses.logistic_l2(1e-3), ds.x, ds.y, ds.layout,
                             engine.EngineConfig(secure=mode), mesh=mesh,
                             device=CPU)
    return ServeEngine(eng, max_batch=BATCH, device=CPU, **kw)


def _port_trace(ds, mode, shape=()):
    return _play(_port(ds, mode, shape), {"w0": ds.w0, "w1": ds.w1},
                 ds.deep)


@pytest.fixture(scope="module")
def jax_traces(ds):
    """The JAX ServeEngine's SCRIPT over each (mode, mesh shape), played
    once for the module."""
    import jax.numpy as jnp
    from repro.core import algorithms as jalg
    from repro.core import deep_vfl as jdeep
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    from repro.serve import ServeEngine as JServe
    from repro.sharding import api as japi

    deep = [jdeep.DeepVFLParams([jnp.asarray(a.numpy()) for a in p.enc_w1],
                                [jnp.asarray(a.numpy()) for a in p.enc_b1],
                                [jnp.asarray(a.numpy()) for a in p.enc_w2],
                                jnp.asarray(p.head.numpy()))
            for p in ds.deep]
    layout = jalg.PartyLayout.even(D, Q, M)
    cache = {}

    def get(mode, shape):
        if (mode, shape) not in cache:
            eng = jeng.FusedEngine(jloss.logistic_l2(1e-3), ds.x, ds.y,
                                   layout, jeng.EngineConfig(secure=mode),
                                   mesh=japi.PartyMesh(**_mesh_kw(shape)))
            cache[mode, shape] = _play(JServe(eng, max_batch=BATCH),
                                       {"w0": ds.w0, "w1": ds.w1}, deep)
        return cache[mode, shape]

    return get


def _plain(ds):
    """The float64 scores of SCRIPT's serve steps (linear: x·w; deep: the
    encoders' logit)."""
    out, w, params = [], None, None
    x64 = ds.x.astype(np.float64)
    weights = {"w0": ds.w0, "w1": ds.w1}
    for act, arg in SCRIPT:
        if act == "weights":
            w, params = weights[arg].astype(np.float64), None
        elif act == "deep":
            params = ds.deep[arg]
        elif params is None:
            out.append(x64[arg] @ w)
        else:
            blocks = [torch.from_numpy(x64[arg, lo:hi])
                      for lo, hi in ds.layout.bounds]
            p64 = deep_vfl.DeepVFLParams(
                *([a.double() for a in leaf] for leaf in
                  (params.enc_w1, params.enc_b1, params.enc_w2)),
                params.head.double())
            out.append(deep_vfl.fused_forward(p64, blocks)[1].numpy())
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", SECURE)
def test_mesh_serving_matches_jax(ds, jax_traces, mode, shape):
    got = _port_trace(ds, mode, shape)
    want = jax_traces(mode, shape)
    prev = dict.fromkeys(("full_dispatches", "hit_dispatches",
                          "delta_dispatches"), 0)
    for (gp, gs), (wp, ws), plain, route in zip(got, want, _plain(ds),
                                                ROUTES):
        np.testing.assert_allclose(gp, wp, **TOL)
        np.testing.assert_allclose(gp, plain, **TOL)
        assert gs == ws
        # the step took its route and no other (10 ids are two chunks)
        moved = {k for k in prev if gs[k] != prev[k]}
        assert moved == {f"{route}_dispatches"}
        prev = {k: gs[k] for k in prev}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_off_is_flat_serving_bit_for_bit(ds, shape):
    for (gp, gs), (fp, fs) in zip(_port_trace(ds, "off", shape),
                                  _port_trace(ds, "off")):
        assert np.array_equal(gp, fp)
        assert gs == fs


@pytest.mark.parametrize("mode", SECURE)
def test_data_axis_serves_the_bits_of_its_mesh(ds, mode):
    """Serving ignores the data axis, as the reference's replicated serve
    programs are shard-invariant: the same (seed, version, counter) mask
    streams give the same bits."""
    for (gp, gs), (wp, ws) in zip(_port_trace(ds, mode, (8, 2, 2)),
                                  _port_trace(ds, mode, (8, 2))):
        assert np.array_equal(gp, wp)
        assert gs == ws


@pytest.mark.parametrize("kind", ["linear", "deep"])
@pytest.mark.parametrize("mode", ["two_tree", "ring"])
def test_packed_hit_replays_cold_bit_for_bit(ds, mode, kind):
    sv = _port(ds, mode, (8, 4))
    if kind == "linear":
        sv.set_weights(ds.w0)
    else:
        sv.set_deep_params(ds.deep[0])
    ids = np.array([5, 1, 40, 5, 7, 5])
    cold = sv.serve(ids)
    assert cold[0] == cold[3] == cold[5]
    assert np.array_equal(cold, sv.serve(ids))
    assert np.array_equal(cold[[1, 2, 4]], sv.serve(ids[[1, 2, 4]]))
    assert sv.stats.full_dispatches == 1 and sv.stats.hit_dispatches == 2


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_queue_over_packed_engine(ds, shape):
    sv = _port(ds, "two_tree", shape)
    sv.set_weights(ds.w0)
    rng = np.random.default_rng(3)
    jobs = [[rng.integers(0, N, size=rng.integers(1, 4)) for _ in range(6)]
            for _ in range(4)]
    results = [[] for _ in jobs]
    with ServeQueue(sv, max_wait=0.01) as q:
        def client(i):
            for ids in jobs[i]:
                results[i].append(q.serve(ids, timeout=30.0))

        pool = [threading.Thread(target=client, args=(i,))
                for i in range(len(jobs))]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60.0)
            assert not t.is_alive()
        assert q.coalesced_batches >= 1
    for i, job in enumerate(jobs):
        assert len(results[i]) == len(job)
        for ids, got in zip(job, results[i]):
            np.testing.assert_allclose(got, ds.x[ids] @ ds.w0, **TOL)
            np.testing.assert_allclose(got, sv.serve(ids), **TOL)
