"""The port's ``ServeEngine`` against the JAX ``ServeEngine``.

Sizes are ``tests/test_serve.py``'s (N=64, D=12, Q=4, M=2); data and
weights are made with numpy from a seed and carried across with
``repro_torch.convert``.

* port vs reference: predictions at rtol = atol = 1e-5 (the tolerance of
  ``test_serve.py``; the masks differ, so the two agree to the mask
  residue) for secure ∈ {off, two_tree, ring} × {linear, deep} and both
  reference kernel routings, and ``ServeStats`` field for field across a
  scripted trace (cold → hits → update → delta → two versions behind →
  full);
* within the port: a hit is bit-exact against the cold dispatch,
  duplicate ids included; invalidate → re-serve is bit-exact against a
  fresh-cache run; delta agrees with full at 1e-5; the queue coalesces
  concurrent submits and relays errors.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, deep_vfl, engine, losses
from repro_torch.kernels import vfl_grad as vg
from repro_torch.serve import ServeEngine, ServeQueue

N, D, Q, M = 64, 12, 4, 2
SECURE = ["off", "two_tree", "ring"]
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = np.where(rng.standard_normal(N) > 0, 1.0, -1.0).astype(np.float32)
    return x, y


def _w(seed=3):
    return np.random.default_rng(seed).standard_normal(D).astype(np.float32)


def _engine(secure="two_tree", **cfg):
    x, y = _data()
    eng = engine.FusedEngine(losses.logistic_l2(1e-3), x, y,
                             algorithms.PartyLayout.even(D, Q, M),
                             engine.EngineConfig(secure=secure, **cfg),
                             device=CPU)
    return eng, x


def _serve(secure="two_tree", max_batch=16, **kw):
    eng, x = _engine(secure)
    return ServeEngine(eng, max_batch=max_batch, device=CPU, **kw), x


def _deep_params(seed=9, hidden=4, d_rep=3):
    gen = torch.Generator().manual_seed(seed)
    return deep_vfl.init_deep_vfl(gen, algorithms.PartyLayout.even(D, Q, M),
                                  D, hidden, d_rep)


def _plain_deep(params, x, ids):
    layout = algorithms.PartyLayout.even(D, Q, M)
    blocks = [torch.from_numpy(x[ids, lo:hi]) for lo, hi in layout.bounds]
    logit = deep_vfl.fused_forward(params, blocks)[1].numpy()
    masked = deep_vfl.fused_forward(params, blocks,
                                    gen=torch.Generator().manual_seed(1))[1]
    np.testing.assert_allclose(masked.numpy(), logit, **TOL)
    return logit


# -- the reference side --------------------------------------------------------

@pytest.fixture
def jax_side():
    """Builds the JAX ServeEngine over the same data (imported here, so the
    file collects where JAX is absent)."""
    import jax.numpy as jnp

    from repro.core import algorithms as jalg
    from repro.core import deep_vfl as jdeep
    from repro.core import losses as jlos
    from repro.core.engine import EngineConfig, FusedEngine
    from repro.serve import ServeEngine as JServe

    def build(secure, use_kernel=False, **kw):
        x, y = _data()
        eng = FusedEngine(jlos.logistic_l2(1e-3), x, y,
                          jalg.PartyLayout.even(D, Q, M),
                          EngineConfig(secure=secure, use_kernel=use_kernel,
                                       interpret=use_kernel))
        return JServe(eng, max_batch=16, **kw)

    def deep(params):
        """The port's parameters as the reference's DeepVFLParams."""
        return jdeep.DeepVFLParams(
            [jnp.asarray(a.numpy()) for a in params.enc_w1],
            [jnp.asarray(a.numpy()) for a in params.enc_b1],
            [jnp.asarray(a.numpy()) for a in params.enc_w2],
            jnp.asarray(params.head.numpy()))

    build.deep = deep
    return build


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", ["linear", "deep"])
@pytest.mark.parametrize("secure", SECURE)
def test_cold_serve_matches_jax(jax_side, secure, kind, use_kernel):
    ref = jax_side(secure, use_kernel)
    sv, x = _serve(secure)
    ids = np.array([5, 1, 40, 5, 63, 0])
    if kind == "linear":
        w = _w()
        ref.set_weights(w)
        sv.set_weights(convert.linear_iterate(w, device=CPU))
        plain = x[ids] @ w
    else:
        params = _deep_params()
        jparams = jax_side.deep(params)
        ref.set_deep_params(jparams)
        # carried across the way a user would: reference arrays -> port
        sv.set_deep_params(convert.deep_params(jparams, device=CPU))
        plain = _plain_deep(params, x, ids)
    out = sv.serve(ids)
    np.testing.assert_allclose(out, ref.serve(ids), **TOL)
    np.testing.assert_allclose(out, plain, **TOL)
    assert dataclasses.asdict(sv.stats) == dataclasses.asdict(ref.stats)


@pytest.mark.parametrize("secure", SECURE)
def test_trace_stats_match_jax(jax_side, secure):
    """cold → hits → update → delta → two versions behind → full: the
    routing (every ServeStats field) and the predictions agree."""
    ref = jax_side(secure)
    sv, _ = _serve(secure)
    w0 = _w()
    hot = np.array([3, 3, 9, 17, 39])

    def step(fn):
        fn(ref)
        fn(sv)

    def both(ids):
        np.testing.assert_allclose(sv.serve(ids), ref.serve(ids), **TOL)
        assert dataclasses.asdict(sv.stats) == dataclasses.asdict(ref.stats)

    step(lambda e: e.set_weights(w0))
    both(np.arange(40))                       # cold, chunked 16/16/8
    both(hot)                                 # hits
    both(np.array([0, 39, 3]))                # hits
    step(lambda e: e.set_weights(w0 * 1.01 + 0.02))
    both(hot)                                 # delta (one version behind)
    both(np.array([3, 50, 9]))                # current + cold mix: full
    step(lambda e: e.set_weights(w0 * 1.1))
    step(lambda e: e.set_weights(w0 * 1.2))
    both(np.array([0, 1]))                    # two versions behind: full
    both(np.array([0, 1]))                    # hits
    assert sv.stats.delta_dispatches == 1 and sv.stats.hit_dispatches == 3


def test_deep_trace_stats_match_jax(jax_side):
    ref = jax_side("two_tree")
    sv, _ = _serve("two_tree")
    for seed, ids in ((9, np.array([2, 2, 9, 33])), (10, np.array([2, 7]))):
        params = _deep_params(seed)
        ref.set_deep_params(jax_side.deep(params))
        sv.set_deep_params(params)
        for _ in range(2):                    # cold, then hits
            np.testing.assert_allclose(sv.serve(ids), ref.serve(ids), **TOL)
    assert dataclasses.asdict(sv.stats) == dataclasses.asdict(ref.stats)
    assert sv.stats.full_dispatches == 2 and sv.stats.hit_dispatches == 2


# -- within the port -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "deep"])
@pytest.mark.parametrize("secure", SECURE)
def test_hit_bit_exact_vs_cold(secure, kind):
    sv, _ = _serve(secure)
    if kind == "linear":
        sv.set_weights(_w())
    else:
        sv.set_deep_params(_deep_params())
    ids = np.array([5, 1, 40, 5, 7, 5])      # duplicate ids in one batch
    cold = sv.serve(ids)
    assert cold[0] == cold[3] == cold[5], "duplicates must emit one winner"
    assert np.array_equal(cold, sv.serve(ids))
    assert np.array_equal(cold[[1, 2, 4]], sv.serve(ids[[1, 2, 4]]))
    assert sv.stats.full_dispatches == 1 and sv.stats.hit_dispatches == 2


@pytest.mark.parametrize("secure", SECURE)
def test_invalidate_reserve_bit_exact_vs_fresh(secure):
    """serve → update → serve equals a fresh-cache engine that saw the same
    update sequence, bit for bit (same (version, counter) mask streams)."""
    ids = np.array([3, 11, 40, 7, 3])
    w0, w1 = _w(), _w(4)
    a, _ = _serve(secure, max_batch=8, delta_refresh=False)
    a.set_weights(w0)
    a.serve(ids)
    a.set_weights(w1)
    second = a.serve(ids)
    assert a.stats.full_dispatches == 2, "update must force a re-dispatch"
    b, _ = _serve(secure, max_batch=8, delta_refresh=False)
    b.set_weights(w0)
    b.set_weights(w1)
    assert np.array_equal(second, b.serve(ids))


@pytest.mark.parametrize("secure", SECURE)
def test_delta_matches_full(secure):
    sv, x = _serve(secure)
    w0 = _w()
    w1 = w0 + 0.01 * _w(4)
    ids = np.array([5, 1, 40, 5, 7])
    sv.set_weights(w0)
    sv.serve(ids)
    sv.set_weights(w1)
    refreshed = sv.serve(ids)
    assert sv.stats.delta_dispatches == 1
    full, _ = _serve(secure, cache=False)
    full.set_weights(w1)
    np.testing.assert_allclose(refreshed, full.serve(ids), **TOL)
    np.testing.assert_allclose(refreshed, x[ids] @ w1, **TOL)
    assert np.array_equal(refreshed, sv.serve(ids))    # repaired entries hit


def test_stale_cache_mutant_fails():
    ids = np.array([3, 11, 40, 7])
    w0, w1 = _w(), _w() * 1.5 + 0.1
    sv, x = _serve("off", max_batch=8)
    sv.set_weights(w0)
    sv.serve(ids)
    sv._wq = sv.eng.pack_w(w1)      # mutant: bypasses set_weights
    mutant = sv.serve(ids)
    assert sv.stats.hit_dispatches == 1, "mutant must have hit stale cache"
    assert np.max(np.abs(mutant - x[ids] @ w1)) > 1e-3
    sv2, _ = _serve("off", max_batch=8)
    sv2.set_weights(w0)
    sv2.serve(ids)
    sv2.set_weights(w1)
    np.testing.assert_allclose(sv2.serve(ids), x[ids] @ w1, **TOL)
    assert sv2.stats.hit_dispatches == 0


@pytest.mark.parametrize("cache", [False, True])
def test_partial_batches_and_boundary_ids(cache):
    eng, x = _engine("ring")
    sv = ServeEngine(eng, max_batch=8, cache=cache, device=CPU)
    w = _w()
    sv.set_weights(w)
    ids = np.array([N - 1, 0, N - 1])   # boundary ids next to the pad slot
    np.testing.assert_allclose(sv.serve(ids), x[ids] @ w, **TOL)
    out = sv.serve(np.array([N - 1]))   # 1-request chunk, 7 pad slots
    again = sv.serve(np.array([N - 1]))
    if cache:                           # a hit replays the stored value
        assert np.array_equal(out, again)
    else:                               # a fresh masked dispatch
        np.testing.assert_allclose(again, out, **TOL)
        assert sv.stats.hit_dispatches == 0
    assert sv.serve(np.array([], dtype=np.int64)).shape == (0,)
    for bad in (N, -1):
        with pytest.raises(ValueError, match="sample ids"):
            sv.serve(np.array([bad]))


def test_requires_weights_and_matching_device():
    sv, _ = _serve("off")
    with pytest.raises(ValueError, match="no weights"):
        sv.serve(np.array([0]))
    with pytest.raises(ValueError, match="weights shape"):
        sv.set_weights(np.zeros((Q, 99), np.float32))
    with pytest.raises(ValueError, match="engine on"):
        ServeEngine(sv.eng, device="meta")


def test_serving_universe_override():
    eng, _ = _engine("off")
    xa = np.random.default_rng(11).standard_normal((100, D)) \
        .astype(np.float32)
    sv = ServeEngine(eng, x=xa, max_batch=8, device=CPU)
    w = _w()
    sv.set_weights(w)
    ids = np.array([99, 0, 64])
    np.testing.assert_allclose(sv.serve(ids), xa[ids] @ w, **TOL)


def test_cpu_serving_builds_and_launches_no_kernel():
    before = dict(vg.KERNEL.launches)
    sv, _ = _serve("two_tree", max_batch=8192)   # wider than any tile
    sv.set_weights(_w())
    sv.serve(np.arange(20))
    sv.set_deep_params(_deep_params())
    sv.serve(np.arange(20))
    assert vg.KERNEL.launches == before and vg.KERNEL._lib is None


def test_every_contraction_goes_through_the_wrapper(monkeypatch):
    """Serving never contracts outside ``ops.vfl_grad``, whatever the
    batch size: on the card that wrapper is the kernel or an error."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.vfl_grad

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "vfl_grad", spy)
    sv, x = _serve("two_tree", max_batch=8192)
    w = _w()
    sv.set_weights(w)
    ids = np.arange(N)
    np.testing.assert_allclose(sv.serve(ids), x[ids] @ w, **TOL)
    sv.serve(ids)                                   # hits
    assert calls == [(Q, 8192, D // Q), (8192, D // Q), (8192, D // Q)]


def test_packing_matches_reference():
    from repro.core import deep_vfl as jdeep
    from repro.core import engine as jeng
    layout = algorithms.PartyLayout.even(13, 4, 2)     # ragged widths
    x = np.random.default_rng(2).standard_normal((10, 13)).astype(np.float32)
    np.testing.assert_array_equal(
        engine.pack_features(x, layout, CPU).numpy(),
        np.asarray(jeng.pack_features(x, layout)))
    w = x[0]
    wq = engine.pack_vec(w, layout, CPU)
    np.testing.assert_array_equal(wq.numpy(),
                                  np.asarray(jeng.pack_vec(w, layout)))
    np.testing.assert_array_equal(engine.unpack_vec(wq, layout), w)
    gen = torch.Generator().manual_seed(1)
    params = deep_vfl.init_deep_vfl(gen, layout, 13, 5, 3)
    pq = engine.pack_deep_params(params, layout, CPU)
    jpq = jeng.pack_deep_params(jdeep.DeepVFLParams(
        [a.numpy() for a in params.enc_w1], [a.numpy() for a in params.enc_b1],
        [a.numpy() for a in params.enc_w2], params.head.numpy()), layout)
    for a, b in zip(pq, jpq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = engine.unpack_deep_params(pq, layout)
    for a, b in zip(back.enc_w1, params.enc_w1):
        assert torch.equal(a, b)
    assert torch.equal(back.head, params.head)
    assert all(torch.equal(a, b) for a, b in
               zip(convert.deep_params(jpq, device=CPU), pq))


# -- continuous batching queue ---------------------------------------------------

def test_queue_coalesces_concurrent_submits():
    sv, x = _serve("two_tree")
    w = _w()
    sv.set_weights(w)
    with ServeQueue(sv, max_wait=0.05) as q:
        tickets = [q.submit(i) for i in range(12)]
        out = np.concatenate([t.result(10.0) for t in tickets])
    np.testing.assert_allclose(out, x[np.arange(12)] @ w, **TOL)
    assert q.coalesced_batches < 12, "no coalescing happened"
    assert np.array_equal(out, sv.serve(np.arange(12)))


def test_queue_multi_id_submits_and_threads():
    sv, x = _serve("ring")
    w = _w()
    sv.set_weights(w)
    results = {}

    def client(lo):
        ids = np.arange(lo, lo + 4)
        results[lo] = (ids, q.serve(ids, timeout=10.0))

    with ServeQueue(sv, max_wait=0.02) as q:
        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in (0, 8, 16, 24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
            assert not t.is_alive()
    assert len(results) == 4
    for ids, out in results.values():
        np.testing.assert_allclose(out, x[ids] @ w, **TOL)
        assert np.array_equal(out, sv.serve(ids))


def test_queue_relays_errors_and_closes():
    sv, _ = _serve("off", max_batch=8)
    sv.set_weights(_w())
    q = ServeQueue(sv, max_wait=0.01)
    t = q.submit(np.array([N + 7]))            # out of range -> relayed
    with pytest.raises(ValueError, match="sample ids"):
        t.result(10.0)
    q.submit(np.array([1])).result(10.0)
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(np.array([0]))
    with pytest.raises(ValueError, match="max_batch"):
        ServeQueue(sv, max_batch=64)
