"""The port's hierarchical party mesh (``PartyMesh`` on one device) against
the JAX package's vmap emulation of it.

* ``PartyMesh``'s factors and its shape, name and device-mesh errors; the
  engine's mismatch errors;
* packed SGD, SVRG and SAGA epochs (and the full-gradient pass), and the
  packed deep SGD and SVRG epochs, against the JAX engine over the same
  ``PartyMesh`` on its own ``_batch_indices`` schedule at 1e-5 across
  ``off``/``two_tree``/``ring``;
* under ``off`` every packed epoch is the flat one bit for bit;
* the data axis: sliced SGD and SVRG against the JAX engine at 1e-5, one
  mask draw a slice, the other epochs shard-invariant, and the
  indivisible-batch error;
* the packed faulted and guarded runners against the oracle drivers;
* ``secure_psum_hier`` and ``secure_psum_hier_members`` cancel over every
  alive pattern at q = 8 as (4, 2) and (2, 4), an all-dead slot adding
  neither value nor mask;
* the ``cuda``-marked test runs packed and sliced epochs on the card with
  no host sync against the CPU engine.

Sizes: n = 64, d = 32 over q = 8 parties with m = 2, batch 8 (8 steps an
epoch); the deep widths hidden 4, d_rep 3 of ``tests/test_hierarchical.py``.
JAX is imported inside module-scoped fixtures.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.core import (algorithms, deep_vfl, engine, faults, losses,
                              secure_agg)
from repro_torch.kernels import ops
from repro_torch.sharding.api import PartyMesh

N, D, Q, M, BATCH = 64, 32, 8, 2, 8
STEPS, LR = N // BATCH, 0.5
HID, DREP, DEEP_LR = 4, 3, 0.05
SECURE = ("off", "two_tree", "ring")
PACKED = ((8, 4), (8, 2))                  # (q, slots): pps 2 and 4
SLICED = ((8, 8, 2), (8, 2, 2))            # (q, slots, data_shards)


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, D)).astype(np.float32) / np.sqrt(D)
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
    from repro.core import losses as jloss
    from repro.sharding import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, alg=jalg, eng=jeng,
                                 deep=jdeep, api=japi,
                                 prob=jloss.logistic_l2(1e-3),
                                 layout=jalg.PartyLayout.even(D, Q, M))


@pytest.fixture(scope="module")
def engines(ds, prob, layout, jx):
    """(JAX engine, port engine) per (mode, mesh shape), built once; the
    shape () is the flat layout."""
    cache = {}

    def get(mode, shape=()):
        if (mode, shape) not in cache:
            x, y = ds
            jmesh = tmesh = None
            if shape:
                kw = dict(q=shape[0], slots=shape[1],
                          data_shards=shape[2] if len(shape) > 2 else 1)
                jmesh, tmesh = jx.api.PartyMesh(**kw), PartyMesh(**kw)
            cache[mode, shape] = (
                jx.eng.FusedEngine(jx.prob, x, y, jx.layout,
                                   jx.eng.EngineConfig(secure=mode),
                                   mesh=jmesh),
                engine.FusedEngine(prob, x, y, layout,
                                   engine.EngineConfig(secure=mode),
                                   mesh=tmesh, device="cpu"))
        return cache[mode, shape]

    return get


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _key(jx, k):
    key = jx.jax.random.PRNGKey(k)
    return key, torch.from_numpy(np.array(jx.alg._batch_indices(
        key, N, BATCH, STEPS)))


# ---------------------------------------------------------------------------
# PartyMesh
# ---------------------------------------------------------------------------

def test_partymesh_factors(jx):
    for kw in (dict(q=64, slots=8), dict(q=8, slots=2, data_shards=2),
               dict(q=4, slots=4)):
        pm, jpm = PartyMesh(**kw), jx.api.PartyMesh(**kw)
        assert (pm.parties_per_slot, pm.packed) \
            == (jpm.parties_per_slot, jpm.packed)
        assert (pm.axis, pm.party_axis, pm.data_axis) \
            == (jpm.axis, jpm.party_axis, jpm.data_axis)
    assert PartyMesh(q=64, slots=8).parties_per_slot == 8
    assert not PartyMesh(q=4, slots=4).packed


@pytest.mark.parametrize("kw,err", [
    (dict(q=10, slots=4), "divide evenly"),
    (dict(q=0, slots=1), ">= 1"),
    (dict(q=4, slots=2, data_shards=0), ">= 1"),
    (dict(q=4, slots=2, axis="p", party_axis="p"), "distinct"),
    (dict(q=4, slots=2, data_axis="party"), "distinct"),
])
def test_partymesh_rejects_bad_shapes(jx, kw, err):
    for cls in (PartyMesh, jx.api.PartyMesh):
        with pytest.raises(ValueError, match=err):
            cls(**kw)


def test_device_mesh_is_not_emulated():
    """A mesh that is not a ``torch.distributed`` ``DeviceMesh`` is
    refused, never emulated on one device (a real device mesh runs in
    ``tests/test_torch_dist_mesh.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        PartyMesh(q=8, slots=2, mesh=object())


def test_engine_rejects_mismatched_mesh(ds, prob):
    x, y = ds
    lay = algorithms.PartyLayout.even(D, 4, 2)
    with pytest.raises(ValueError, match="PartyMesh.q=8 != layout.q=4"):
        engine.FusedEngine(prob, x, y, lay, mesh=PartyMesh(q=8, slots=4),
                           device="cpu")
    with pytest.raises(TypeError, match="PartyMesh"):
        engine.FusedEngine(prob, x, y, lay, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# packed epochs
# ---------------------------------------------------------------------------

def _w0(jx, je):
    return je.pack_w((0.1 * np.random.default_rng(3).standard_normal(D))
                     .astype(np.float32))


@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("shape,algo", [(s, a) for s in PACKED
                                        for a in ("sgd", "svrg")]
                         + [(PACKED[0], "saga")])
def test_packed_epochs_match_jax(engines, jx, shape, algo, mode):
    """Two chained epochs on both engines over the same ``PartyMesh``;
    SVRG's full gradient and SAGA's table and average held too."""
    je, te = engines(mode, shape)
    jw = _w0(jx, je)
    tw = torch.from_numpy(np.array(jw))
    if algo == "saga":
        jtab, javg = je.saga_init(jw, jx.jax.random.PRNGKey(0))
        ttab, tavg = (torch.from_numpy(np.array(a)) for a in (jtab, javg))
        _close(ttab, te.saga_init(tw)[0])
    for k in (21, 22):
        key, idx = _key(jx, k)
        if algo == "sgd":
            jw = je.sgd_epoch(jw, LR, key, BATCH, STEPS)
            tw = te.sgd_epoch(tw, LR, idx, (k,))
        elif algo == "svrg":
            jmu, tmu = je.full_gradient(jw, key), te.full_gradient(tw, (k,))
            _close(tmu, jmu)
            jw = je.svrg_epoch(jw, jw, jmu, LR, key, BATCH, STEPS)
            tw = te.svrg_epoch(tw, tw, tmu, LR, idx, (k,))
        else:
            jw, jtab, javg = je.saga_epoch(jw, jtab, javg, LR, key, BATCH,
                                           STEPS)
            tw, ttab, tavg = te.saga_epoch(tw, ttab, tavg, LR, idx, (k,))
            _close(ttab, jtab)
            _close(tavg, javg)
        _close(tw, jw)


@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("algo", ("sgd", "svrg"))
def test_packed_deep_matches_jax(engines, jx, algo, mode):
    """Two chained deep epochs over ``PartyMesh(q=8, slots=2)``, every
    leaf at 1e-5 (SVRG's μ too)."""
    je, te = engines(mode, (8, 2))
    jpq = je.pack_deep(jx.deep.init_deep_vfl(jx.jax.random.PRNGKey(0),
                                             jx.layout, D, HID, DREP))
    tpq = tuple(torch.from_numpy(np.array(a)) for a in jpq)
    for k in (31, 32):
        key, idx = _key(jx, k)
        if algo == "sgd":
            jpq = je.deep_sgd_epoch(jpq, DEEP_LR, key, BATCH, STEPS)
            tpq = te.deep_sgd_epoch(tpq, DEEP_LR, idx, (k,))
        else:
            jmu, tmu = je.deep_full_gradient(jpq, key), \
                te.deep_full_gradient(tpq, (k,))
            for a, b in zip(tmu, jmu):
                _close(a, b)
            jpq = je.deep_svrg_epoch(jpq, jpq, jmu, DEEP_LR, key, BATCH,
                                     STEPS)
            tpq = te.deep_svrg_epoch(tpq, tpq, tmu, DEEP_LR, idx, (k,))
        for a, b in zip(tpq, jpq):
            _close(a, b)


def test_packed_off_is_flat_bitwise(engines, layout):
    """Under ``off`` the packed engines keep the plain party sum: every
    epoch kind gives the flat engine's bits."""
    flat = engines("off")[1]
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    midx = algorithms.epoch_indices(0, 0, N, M * BATCH, STEPS)
    wq = flat.pack_w(0.1 * np.random.default_rng(4).standard_normal(D))
    pq = flat.pack_deep(deep_vfl.initial_params(0, layout, D, HID, DREP))
    tab, avg = flat.saga_init(wq)
    sched = faults.random_trace(layout, STEPS, rate=0.2, p_corrupt=0.1,
                                seed=2).compile(M)
    rows = list(sched.party_rows()) + [sched.corrupt_rows()]
    delays = np.zeros(Q, np.int32)

    def run(e):
        return [
            e.sgd_epoch(wq, LR, idx), e.svrg_epoch(wq, wq, avg, LR, idx),
            *e.saga_epoch(wq, tab, avg, LR, idx),
            e.multi_sgd_epoch(wq, LR, midx),
            e.pipelined_svrg_epoch(wq, wq, avg, LR, idx),
            *e.deep_sgd_epoch(pq, DEEP_LR, idx),
            *e.guarded_sgd_epoch(wq, torch.zeros(Q, 3, e.dp), 0, delays,
                                 *rows, LR, idx, 2)[:2],
            *e.deep_faulted_sgd_epoch(pq, e.deep_delay_buffers(pq, 2), 0,
                                      delays, *rows[:3], DEEP_LR, idx,
                                      2)[0]]

    want = run(flat)
    for shape in PACKED:
        for a, b in zip(run(engines("off", shape)[1]), want):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("shape", SLICED)
def test_data_axis_sgd_matches_jax(engines, jx, shape, mode):
    je, te = engines(mode, shape)
    jw = _w0(jx, je)
    tw = torch.from_numpy(np.array(jw))
    for k in (41, 42):
        key, idx = _key(jx, k)
        jw = je.sgd_epoch(jw, LR, key, BATCH, STEPS)
        tw = te.sgd_epoch(tw, LR, idx, (k,))
        _close(tw, jw)


@pytest.mark.parametrize("mode", ("off", "two_tree"))
@pytest.mark.parametrize("shape", SLICED)
def test_data_axis_svrg_matches_jax(engines, jx, shape, mode):
    je, te = engines(mode, shape)
    jw = _w0(jx, je)
    tw = torch.from_numpy(np.array(jw))
    key, idx = _key(jx, 43)
    jmu, tmu = je.full_gradient(jw, key), te.full_gradient(tw, (43,))
    _close(tmu, jmu)
    _close(te.svrg_epoch(tw, tw, tmu, LR, idx, (43,)),
           je.svrg_epoch(jw, jw, jmu, LR, key, BATCH, STEPS))


def test_data_axis_draws_a_mask_set_a_slice(engines, monkeypatch):
    """A sliced step aggregates each of its ``data_shards`` slices apart
    (a mask draw each) after one forward launch, then one backward over
    the whole batch; the other epochs ignore the data axis."""
    te = engines("ring", (8, 2, 2))[1]
    packed = engines("ring", (8, 2))[1]
    calls = {"agg": 0, "vfl_grad": 0}
    real_agg, real_vg = te._agg, ops.vfl_grad

    def agg(z, gen):
        calls["agg"] += 1
        assert z.shape[1] == BATCH // 2
        return real_agg(z, gen)

    def vg(*args, **kw):
        calls["vfl_grad"] += 1
        assert args[0].shape[1] == BATCH
        return real_vg(*args, **kw)

    monkeypatch.setattr(te, "_agg", agg)
    monkeypatch.setattr(ops, "vfl_grad", vg)
    idx = algorithms.epoch_indices(1, 0, N, BATCH, STEPS)
    wq = te.pack_w(np.zeros(D, np.float32))
    te.sgd_epoch(wq, LR, idx)
    assert calls == {"agg": 2 * STEPS, "vfl_grad": 2 * STEPS}
    monkeypatch.undo()
    midx = algorithms.epoch_indices(1, 0, N, M * BATCH, STEPS)
    for name, args in (("multi_sgd_epoch", (wq, LR, midx, (5,))),
                       ("pipelined_sgd_epoch", (wq, LR, idx, (5,)))):
        assert torch.equal(getattr(te, name)(*args),
                           getattr(packed, name)(*args))


def test_data_axis_rejects_indivisible_batch(ds, prob, layout):
    x, y = ds
    te = engine.FusedEngine(prob, x, y, layout,
                            mesh=PartyMesh(q=Q, slots=4, data_shards=3),
                            device="cpu")
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    with pytest.raises(ValueError, match="data_shards=3"):
        te.sgd_epoch(te.pack_w(np.zeros(D, np.float32)), LR, idx)


# ---------------------------------------------------------------------------
# faulted and guarded runners over a packed mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("faulted", "guarded"))
def test_packed_fault_runners_match_oracle_drivers(ds, prob, layout, kind):
    """``mesh=PartyMesh(q=8, slots=2)`` on the fault runners: the
    two-level membership aggregation gives the oracle driver's iterate
    at 1e-5 in every secure mode (the telemetry pinned)."""
    x, y = ds
    tr = faults.random_trace(layout, STEPS, rate=0.15, max_straggle=2,
                             p_corrupt=0.3 if kind == "guarded" else 0.0,
                             corrupt_modes=("nan",), seed=4)
    kw = dict(tau=2, epochs=1, lr=0.3, batch=BATCH, seed=0, device="cpu")
    ref = getattr(faults, f"run_{kind}_reference")(prob, x, y, layout, tr,
                                                   **kw)
    for mode in SECURE:
        got = getattr(faults, f"run_{kind}_fused")(
            prob, x, y, layout, tr, mesh=PartyMesh(q=Q, slots=2),
            engine_config=engine.EngineConfig(secure=mode), **kw)
        if kind == "guarded":
            np.testing.assert_array_equal(got[1].alive, ref[1].alive)
            np.testing.assert_allclose(got[1].pnorm, ref[1].pnorm,
                                       rtol=1e-4, atol=1e-4)
            _close(got[0], ref[0])
        else:
            _close(got, ref)


# ---------------------------------------------------------------------------
# the two-level aggregations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", (4, 2))
@pytest.mark.parametrize("mode", ("two_tree", "ring"))
def test_hier_members_cancel_over_every_alive_pattern(slots, mode):
    z = torch.from_numpy(np.random.default_rng(slots).standard_normal(
        (Q, 5, 2)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    pps = Q // slots
    dead_slot_seen = False
    for bits in itertools.product((0.0, 1.0), repeat=Q):
        alive = torch.tensor(bits)
        if not alive.any():
            continue
        seen = []
        got = secure_agg.secure_psum_hier_members(z, gen, alive, slots,
                                                  mode=mode, transcript=seen)
        torch.testing.assert_close(got, (alive[:, None, None] * z).sum(0),
                                   atol=1e-5, rtol=0)
        inner, outer = seen
        dead = alive.view(slots, pps).T == 0             # (pps, slots)
        assert not inner[dead].any()         # a crashed party: no value
        slot_dead = dead.all(0)
        assert not outer[slot_dead].any()    # a dead slot: no value, no mask
        dead_slot_seen |= bool(slot_dead.any())
    assert dead_slot_seen


@pytest.mark.parametrize("slots", (4, 2))
@pytest.mark.parametrize("mode,faithful", [("two_tree", False),
                                           ("two_tree", True),
                                           ("ring", False)])
def test_hier_psum_is_the_sum_and_masks_every_value(slots, mode, faithful):
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (Q, 6)).astype(np.float32))
    seen = []
    got = secure_agg.secure_psum_hier(z, torch.Generator().manual_seed(0),
                                      slots, mode=mode,
                                      schedule_faithful=faithful,
                                      transcript=seen)
    torch.testing.assert_close(got, z.sum(0), atol=1e-5, rtol=0)
    inner, outer = seen
    assert inner.shape == (Q // slots, slots, 6) and outer.shape == (slots, 6)
    raw = z.view(slots, Q // slots, 6).transpose(0, 1)
    assert not torch.isclose(inner, raw, atol=1e-3).any()
    assert not torch.isclose(outer, raw.sum(0), atol=1e-3).any()


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
def test_cuda_mesh_epochs_match_cpu_without_a_sync(cuda_device, ds, layout,
                                                   prob, mode):
    """Packed and sliced SGD and SVRG on the card under
    ``set_sync_debug_mode("error")``, one narrow forward and one rows
    backward a step, within 1e-5 of the CPU engine; a second run equal
    bit for bit."""
    from repro_torch.kernels import vfl_grad as vg
    x, y = ds
    idx = algorithms.epoch_indices(0, 0, N, BATCH, STEPS)
    for kw in (dict(q=Q, slots=2), dict(q=Q, slots=2, data_shards=2)):
        cfg = engine.EngineConfig(secure=mode)
        ec = engine.FusedEngine(prob, x, y, layout, cfg,
                                mesh=PartyMesh(**kw), device="cpu")
        eg = engine.FusedEngine(prob, x, y, layout, cfg,
                                mesh=PartyMesh(**kw), device=cuda_device)
        wq = ec.pack_w(0.1 * np.random.default_rng(0).standard_normal(D))
        mu = ec.full_gradient(wq)
        # staged before the epochs run: a host-to-device copy inside one
        # would synchronise
        ins = {dev: (wq.to(dev), mu.to(dev), idx.to(dev))
               for dev in ("cpu", cuda_device)}

        def run(e, dev):
            w, m, ix = ins[dev]
            return [e.sgd_epoch(w, LR, ix, (1,)),
                    e.svrg_epoch(w, w, m, LR, ix, (2,))]

        for _ in range(2):
            vg.KERNEL.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = run(eg, cuda_device)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert vg.KERNEL.launches["vfl_forward_narrow"] == 2 * STEPS
            assert vg.KERNEL.launches["vfl_backward_rows"] == 2 * STEPS
        again = run(eg, cuda_device)
        for a, b, c in zip(got, again, run(ec, "cpu")):
            assert torch.equal(a, b)
            torch.testing.assert_close(a.cpu(), c, atol=1e-5, rtol=0)
