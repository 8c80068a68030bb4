"""The port's deep and bounded-delay VFB² on a ``torch.distributed`` device
mesh (``PartyMesh(mesh=DeviceMesh)``) against the JAX package.

Two worlds of gloo ranks on the CPU, spawned once each (a ``FileStore``
under the test's temporary directory, one torch thread a rank); each runs
all of its cases and hands its results back as numpy arrays:

* ``flat``: 4 ranks, ``PartyMesh(q=4, slots=4)``, on
  ``tests/test_multidevice.py``'s data (256 × 26, ``PartyLayout.even(26,
  4, 2)``, batch 32, 8 steps) at the deep widths hidden 4, d_rep 3: the
  eight deep epochs under ``off``, ``two_tree`` and ``ring`` (SVRG from
  ``deep_full_gradient``), ``deep_objective`` and ``unpack_deep``; the
  four linear and four deep bounded-delay epochs at τ = 2 under
  ``two_tree`` and ``ring``, with delays that differ across the parties
  ((0, 2, 1, 2), and a (q, m) table that is not symmetric); deep serving
  (full and hit requests);
* ``data``: 4 ranks as data 2 × model 2, ``PartyMesh(q=8, slots=2,
  data_shards=2)`` on ``tests/test_torch_mesh.py``'s data (64 × 32, q =
  8): deep SGD and SVRG, a linear and a deep delayed epoch, under
  ``off`` and ``two_tree``.

Each epoch runs on the reference's own ``_batch_indices`` schedule and is
held to the JAX ``FusedEngine``'s one-device emulation (flat; the data
world against its packed ``PartyMesh(q=8, slots=2, data_shards=2)``
engine) at 1e-5 absolute: every leaf gathered over the model group, SVRG's
μ, the rings and the counter.  Locality: a rank's ``xs``, deep leaves and
rings hold only its slot's parties' rows, which are the reference's rows
of those parties; the head's copies are equal on every rank; the two data
replicas of each slot agree bit for bit.  JAX runs only in this process,
inside the fixtures; the ranks import torch and the port alone.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch

ATOL = 1e-5
MODES = ("off", "two_tree", "ring")
HID, DREP, DEEP_LR, TAU = 4, 3, 0.05, 2
# flat: tests/test_multidevice.py's engine case; data: test_torch_mesh's
FLAT = dict(n=256, d=26, q=4, m=2, batch=32, steps=8, lr=0.3, lam=None)
SMALL = dict(n=64, d=32, q=8, m=2, batch=8, steps=8, lr=0.5, lam=1e-3)
DEEP = ("deep_sgd", "deep_svrg", "deep_multi_sgd", "deep_multi_svrg",
        "deep_pipelined_sgd", "deep_pipelined_svrg",
        "deep_multi_pipelined_sgd", "deep_multi_pipelined_svrg")
DELAYED = ("delayed_sgd", "multi_delayed_sgd", "pipelined_delayed_sgd",
           "multi_pipelined_delayed_sgd", "deep_delayed_sgd",
           "deep_multi_delayed_sgd", "deep_pipelined_delayed_sgd",
           "deep_multi_pipelined_delayed_sgd")
DATA_KINDS = ("deep_sgd", "deep_svrg", "delayed_sgd", "deep_delayed_sgd")
DATA_MODES = ("off", "two_tree")
# per-party delays that differ across the parties, and a (q, m) table
# whose columns differ: a rank that read another party's delay would
# apply another step's gradient
DELAYS = {4: np.array([0, 2, 1, 2]), 8: np.array([0, 2, 1, 2, 2, 0, 1, 1])}
DELAYS_QM = np.array([[0, 2], [1, 0], [2, 1], [1, 2]])
# deep serving: (new params' scale or None, ids): cold (chunked 16/16/8),
# hits, a new version cold, hits
SERVE_TRACE = ((1.0, np.arange(40)), (None, np.array([3, 3, 9, 39])),
               (1.1, np.array([2, 7, 2])), (None, np.array([7, 2])))
WORLDS = {"flat": 4, "data": 4}
SPAWN_TIMEOUT = 600


def _data(cfg):
    if cfg is FLAT:            # tests/test_multidevice.py's data
        rng = np.random.default_rng(0)
        x = rng.standard_normal((cfg["n"], cfg["d"])).astype(np.float32)
        y = np.sign(rng.standard_normal(cfg["n"])).astype(np.float32)
        return x, y
    rng = np.random.default_rng(11)
    x = rng.normal(size=(cfg["n"], cfg["d"])).astype(np.float32) \
        / np.sqrt(cfg["d"])
    y = (rng.random(cfg["n"]) > 0.5).astype(np.float32) * 2 - 1
    return x, y


def _w0(cfg):
    return (0.1 * np.random.default_rng(3).standard_normal(cfg["d"])) \
        .astype(np.float32)


def _multi(kind):
    return "multi" in kind


def _delays(q, kind):
    return DELAYS_QM if _multi(kind) else DELAYS[q]


def _lr(cfg, kind):
    return DEEP_LR if kind.startswith("deep") else cfg["lr"]


# ---------------------------------------------------------------------------
# the ranks (spawned; torch and the port only)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy().copy()


def _engine(cfg, mode, pm, x, y):
    from repro_torch.core import algorithms, engine, losses
    prob = losses.logistic_l2() if cfg["lam"] is None \
        else losses.logistic_l2(cfg["lam"])
    layout = algorithms.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])
    return engine.FusedEngine(prob, x, y, layout,
                              engine.EngineConfig(secure=mode), mesh=pm,
                              device="cpu")


def _params(inputs, scale=1.0):
    """The reference's deep start (every leaf times ``scale``) as the
    port's ``DeepVFLParams``."""
    from repro_torch.core.deep_vfl import DeepVFLParams
    w1, b1, w2, head = inputs["params"]
    return DeepVFLParams([a * scale for a in w1], [a * scale for a in b1],
                         [a * scale for a in w2], head * scale)


def _run_kind(eng, cfg, kind, inputs, key):
    """``kind``'s epoch from the reference's start (w0, or its deep
    params; SVRG from its own ``deep_full_gradient``, a delayed epoch
    from zeroed rings at step 0); returns the whole results, gathered
    over the model group, and the rank's own rows of each."""
    fn = getattr(eng, f"{kind}_epoch")
    idx, lr = inputs["idx"][_multi(kind)], _lr(cfg, kind)
    out, mine = {}, {}
    if kind.startswith("deep"):
        pq = eng.pack_deep(_params(inputs))
        if "delayed" in kind:
            bufq = (eng.deep_multi_delay_buffers if _multi(kind)
                    else eng.deep_delay_buffers)(pq, TAU)
            delays = eng.local(torch.from_numpy(_delays(cfg["q"], kind)))
            pq, bufq, t = fn(pq, bufq, 0, delays, lr, idx, TAU, key)
            out["t"] = _np(t)
            for i, r in enumerate(bufq):
                out[f"ring{i}"], mine[f"ring{i}"] = _np(eng.gather(r)), _np(r)
        elif kind.endswith("svrg"):
            mu = eng.deep_full_gradient(pq, key)
            for i, a in enumerate(mu):
                out[f"mu{i}"] = _np(eng.gather(a))
            pq = fn(pq, pq, mu, lr, idx, key)
        else:
            pq = fn(pq, lr, idx, key)
        for i, a in enumerate(pq):
            out[f"leaf{i}"], mine[f"leaf{i}"] = _np(eng.gather(a)), _np(a)
        return out, mine, pq
    dp, q = eng.dp, cfg["q"]
    ring = torch.zeros((q, TAU + 1, dp) + ((cfg["m"],) if _multi(kind)
                                           else ()))
    w, bufq, t = fn(eng.pack_w(_w0(cfg)), eng.local(ring), 0,
                    eng.local(torch.from_numpy(_delays(q, kind))), lr, idx,
                    TAU, key)
    out["w"], out["ring0"], out["t"] = eng.unpack_w(w), \
        _np(eng.gather(bufq)), _np(t)
    mine["ring0"] = _np(bufq)
    return out, mine, None


def _deep_serve(eng, inputs):
    """Deep serving's trace: the reference's params cold (chunked), hits,
    new params cold then hits.  Returns the answers, the final stats and
    how often this rank ran the dominator's answer."""
    from repro_torch.serve.engine import ServeEngine
    sv = ServeEngine(eng, max_batch=16, device="cpu")
    calls, dom = [], sv._dominator

    def counted(fn):
        def f():
            calls.append(1)
            return fn()
        return dom(f)

    sv._dominator = counted
    out = []
    for scale, ids in SERVE_TRACE:
        if scale is not None:
            sv.set_deep_params(_params(inputs, scale))
        out.append(sv.serve(ids))
    return dict(out=out, stats=dataclasses.asdict(sv.stats),
                dominator_calls=len(calls), dispatches=sv.stats.dispatches)


def _case_flat(inputs):
    from repro_torch.launch.mesh import make_device_mesh
    cfg = FLAT
    pm = make_device_mesh(cfg["q"], backend="gloo", device="cpu")
    x, y = _data(cfg)
    res = {"slot": pm.slot, "parties": list(pm.parties)}
    for mode in MODES:
        eng = _engine(cfg, mode, pm, x, y)
        kinds = DEEP + (DELAYED if mode != "off" else ())
        for kind in kinds:
            out, mine, pq = _run_kind(eng, cfg, kind, inputs, (21,))
            res[mode, kind], res[mode, kind, "mine"] = out, mine
            if kind == "deep_sgd":
                up = eng.unpack_deep(pq)
                res[mode, "unpack"] = [_np(a) for a in (
                    *up.enc_w1, *up.enc_b1, *up.enc_w2, up.head)]
        pq0 = eng.pack_deep(_params(inputs))
        res[mode, "objective"] = eng.deep_objective(pq0)
        res[mode, "serve"] = _deep_serve(eng, inputs)
        if mode == "off":
            res["xs_shape"] = tuple(eng.xs.shape)
    return res


def _case_data(inputs):
    from repro_torch.launch.mesh import make_device_mesh
    cfg = SMALL
    pm = make_device_mesh(2, q=cfg["q"], backend="gloo", device="cpu")
    x, y = _data(cfg)
    res = {"slot": pm.slot, "data_index": pm.data_index,
           "parties": list(pm.parties)}
    for mode in DATA_MODES:
        eng = _engine(cfg, mode, pm, x, y)
        for kind in DATA_KINDS:
            res[mode, kind], res[mode, kind, "mine"] = _run_kind(
                eng, cfg, kind, inputs, (41,))[:2]
        res["xs_shape"] = tuple(eng.xs.shape)
    return res


def _rank(rank, world, kind, base):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(base, "store"), world),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(base, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        res = {"flat": _case_flat, "data": _case_data}[kind](inputs)
        with open(os.path.join(base, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()          # no rank leaves while another still sends
    finally:
        dist.destroy_process_group()
    # leave without the interpreter's teardown: a gloo thread still
    # joinable there can abort a rank whose record is already written
    os._exit(0)


# ---------------------------------------------------------------------------
# this process: the worlds, the reference
# ---------------------------------------------------------------------------

def _spawn(kind, base, inputs):
    import torch.multiprocessing as mp
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return mp.start_processes(_rank, args=(WORLDS[kind], kind, str(base)),
                              nprocs=WORLDS[kind], join=False,
                              start_method="spawn")


def _join(ctx, base, world):
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a world of {world} ranks did not finish "
                               f"within {SPAWN_TIMEOUT} s")
    out = []
    for r in range(world):
        with open(os.path.join(base, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp
    from repro.core import algorithms as jalg
    from repro.core import deep_vfl as jdeep
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    from repro.serve import ServeEngine
    from repro.sharding import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, alg=jalg, deep=jdeep,
                                 eng=jeng, loss=jloss, api=japi,
                                 serve=ServeEngine)


def _layout(jx, cfg):
    return jx.alg.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])


def _inputs(jx, cfg, k):
    """The reference's schedules of key k (by multi-dominator or not) and
    its deep start, as numpy."""
    key = jx.jax.random.PRNGKey(k)
    p = jx.deep.init_deep_vfl(jx.jax.random.PRNGKey(0), _layout(jx, cfg),
                              cfg["d"], HID, DREP)
    return {"idx": {multi: np.array(jx.alg._batch_indices(
        key, cfg["n"], (cfg["m"] if multi else 1) * cfg["batch"],
        cfg["steps"])) for multi in (False, True)},
        "params": ([np.asarray(a) for a in p.enc_w1],
                   [np.asarray(a) for a in p.enc_b1],
                   [np.asarray(a) for a in p.enc_w2], np.asarray(p.head))}


def _ref_engine(jx, cfg, mode, pm=None):
    x, y = _data(cfg)
    prob = jx.loss.logistic_l2() if cfg["lam"] is None \
        else jx.loss.logistic_l2(cfg["lam"])
    return jx.eng.FusedEngine(prob, x, y, _layout(jx, cfg),
                              jx.eng.EngineConfig(secure=mode),
                              mesh=None if pm is None
                              else jx.api.PartyMesh(**pm))


def _ref_params(jx, inputs, scale=1.0):
    w1, b1, w2, head = inputs["params"]
    arr = jx.jnp.asarray
    return jx.deep.DeepVFLParams([arr(a * scale) for a in w1],
                                 [arr(a * scale) for a in b1],
                                 [arr(a * scale) for a in w2],
                                 arr(head * scale))


def _ref_kind(jx, je, cfg, kind, inputs, k):
    fn = getattr(je, f"{kind}_epoch")
    key, b, s = jx.jax.random.PRNGKey(k), cfg["batch"], cfg["steps"]
    lr, out = _lr(cfg, kind), {}
    if kind.startswith("deep"):
        pq = je.pack_deep(_ref_params(jx, inputs))
        if "delayed" in kind:
            bufq = (je.deep_multi_delay_buffers if _multi(kind)
                    else je.deep_delay_buffers)(pq, TAU)
            delays = jx.jnp.asarray(_delays(cfg["q"], kind), jx.jnp.int32)
            pq, bufq, t = fn(pq, bufq, jx.jnp.zeros((), jx.jnp.int32),
                             delays, lr, key, b, s, TAU)
            out["t"] = np.asarray(t)
            for i, r in enumerate(bufq):
                out[f"ring{i}"] = np.asarray(r)
        elif kind.endswith("svrg"):
            mu = je.deep_full_gradient(pq, key)
            for i, a in enumerate(mu):
                out[f"mu{i}"] = np.asarray(a)
            pq = fn(pq, pq, mu, lr, key, b, s)
        else:
            pq = fn(pq, lr, key, b, s)
        for i, a in enumerate(pq):
            out[f"leaf{i}"] = np.asarray(a)
        return out, pq
    shape = (cfg["q"], TAU + 1, int(je.xs.shape[2])) \
        + ((cfg["m"],) if _multi(kind) else ())
    w, bufq, t = fn(je.pack_w(_w0(cfg)), jx.jnp.zeros(shape, jx.jnp.float32),
                    jx.jnp.zeros((), jx.jnp.int32),
                    jx.jnp.asarray(_delays(cfg["q"], kind), jx.jnp.int32),
                    lr, key, b, s, TAU)
    out["w"], out["ring0"], out["t"] = je.unpack_w(w), np.asarray(bufq), \
        np.asarray(t)
    return out, None


def _ref_serve(jx, je, inputs):
    sv = jx.serve(je, max_batch=16)
    out = []
    for scale, ids in SERVE_TRACE:
        if scale is not None:
            sv.set_deep_params(_ref_params(jx, inputs, scale))
        out.append(np.asarray(sv.serve(ids)))
    return dict(out=out, stats=dataclasses.asdict(sv.stats))


@pytest.fixture(scope="module")
def runs(jx, tmp_path_factory):
    """Start the two worlds, compute the reference while they run, then
    collect every rank's results."""
    base = tmp_path_factory.mktemp("dist_deep")
    inputs = {"flat": _inputs(jx, FLAT, 21), "data": _inputs(jx, SMALL, 41)}
    ctxs = {kind: _spawn(kind, base / kind, inputs[kind])
            for kind in WORLDS}
    try:
        ref = {}
        for mode in MODES:
            je = _ref_engine(jx, FLAT, mode)
            for kind in DEEP + (DELAYED if mode != "off" else ()):
                ref["flat", mode, kind], pq = _ref_kind(
                    jx, je, FLAT, kind, inputs["flat"], 21)
                if kind == "deep_sgd":
                    up = je.unpack_deep(pq)
                    ref["flat", mode, "unpack"] = [np.asarray(a) for a in (
                        *up.enc_w1, *up.enc_b1, *up.enc_w2, up.head)]
            ref["flat", mode, "objective"] = je.deep_objective(
                je.pack_deep(_ref_params(jx, inputs["flat"])))
            ref["flat", mode, "serve"] = _ref_serve(jx, je, inputs["flat"])
        for mode in DATA_MODES:
            je = _ref_engine(jx, SMALL, mode,
                             pm=dict(q=8, slots=2, data_shards=2))
            for kind in DATA_KINDS:
                ref["data", mode, kind] = _ref_kind(
                    jx, je, SMALL, kind, inputs["data"], 41)[0]
    finally:
        got = {kind: _join(ctxs[kind], base / kind, WORLDS[kind])
               for kind in WORLDS}
    return ref, got


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        for name, a in ranks[0][key].items():
            np.testing.assert_array_equal(r[key][name], a)


def _match(ref, got, world, mode, kind):
    """Every rank's gathered results the same bits, and the reference's
    within ``ATOL``; each rank's own rows the reference's rows of its
    parties."""
    ranks = got[world]
    _same_on_every_rank(ranks, (mode, kind))
    want = ref[world, mode, kind]
    assert set(ranks[0][mode, kind]) == set(want)
    for name, a in ranks[0][mode, kind].items():
        _close(a, want[name])
    for r in ranks:
        for name, a in r[mode, kind, "mine"].items():
            assert a.shape[0] == len(r["parties"])
            _close(a, want[name][r["parties"]])


# ---------------------------------------------------------------------------
# the epochs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", DEEP)
def test_flat_deep_epochs_match_jax(runs, kind, mode):
    """4 ranks, one party each: every leaf of the eight deep epochs (and
    SVRG's ``deep_full_gradient``) against the reference."""
    _match(*runs, "flat", mode, kind)


@pytest.mark.parametrize("mode", ("two_tree", "ring"))
@pytest.mark.parametrize("kind", DELAYED)
def test_flat_delayed_epochs_match_jax(runs, kind, mode):
    """The four linear and four deep bounded-delay epochs at τ = 2 with
    per-party delays (0, 2, 1, 2) and a (q, m) table: the iterate, every
    ring slot and the counter, the rank's ring rows its own parties'."""
    _match(*runs, "flat", mode, kind)


@pytest.mark.parametrize("mode", DATA_MODES)
@pytest.mark.parametrize("kind", DATA_KINDS)
def test_data_axis_deep_and_delayed_match_jax(runs, kind, mode):
    """Data 2 × model 2: the deep and delayed epochs run whole on each
    data shard, against the reference's packed data-axis engine; all four
    ranks (the two data replicas of each slot among them) the same
    bits."""
    _match(*runs, "data", mode, kind)


@pytest.mark.parametrize("mode", MODES)
def test_deep_objective_over_the_ranks(runs, mode):
    """``deep_objective`` sums the layer-2 partials and the encoders'
    regularisers over the ranks and the head's once: the same float on
    every rank, the reference's."""
    ref, got = runs
    vals = {r[mode, "objective"] for r in got["flat"]}
    assert len(vals) == 1
    assert abs(vals.pop() - ref["flat", mode, "objective"]) < 1e-6


@pytest.mark.parametrize("mode", MODES)
def test_unpack_deep_gathers_the_reference_params(runs, mode):
    ref, got = runs
    for r in got["flat"]:
        for a, b in zip(r[mode, "unpack"], ref["flat", mode, "unpack"],
                        strict=True):
            _close(a, b)


@pytest.mark.parametrize("world", ("flat", "data"))
def test_head_copies_equal_on_every_rank(runs, world):
    """The replicated head: every rank's copies of it the same bits after
    each deep epoch."""
    ranks = runs[1][world]
    for key in ranks[0]:
        if isinstance(key, tuple) and key[-1] == "mine" \
                and key[1].startswith("deep"):
            heads = np.concatenate([r[key]["leaf3"] for r in ranks])
            assert (heads == heads[0]).all(), key


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_deep_serve_over_ranks_matches_jax(runs, mode):
    """Deep full and hit requests, and a new version: every answer and
    every ``ServeStats`` field as the reference's, on every rank; the
    dominator's answer computed on the rank of party 0 only, once a
    dispatch."""
    ref, got = runs
    want = ref["flat", mode, "serve"]
    assert want["stats"]["full_dispatches"] == 4
    assert want["stats"]["hit_dispatches"] == 2
    for r in got["flat"]:
        mine = r[mode, "serve"]
        assert mine["stats"] == want["stats"]
        for a, b in zip(mine["out"], want["out"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert mine["dominator_calls"] == (
            mine["dispatches"] if 0 in r["parties"] else 0)


# ---------------------------------------------------------------------------
# locality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ("flat", "data"))
def test_rank_holds_only_its_slot(runs, world):
    """``xs`` and every leaf and ring hold the rank's slot's parties' rows
    only; data 2 × model 2 puts rank r at (data r // 2, slot r % 2)."""
    got = runs[1][world]
    cfg = FLAT if world == "flat" else SMALL
    pps = cfg["q"] // (len(got) if world == "flat" else 2)
    for rank, r in enumerate(got):
        slot = rank if world == "flat" else rank % 2
        if world == "data":
            assert r["data_index"] == rank // 2
        assert r["slot"] == slot
        assert r["parties"] == list(range(slot * pps, (slot + 1) * pps))
        assert r["xs_shape"][:2] == (pps, cfg["n"])
        for key, mine in r.items():
            if isinstance(key, tuple) and key[-1] == "mine":
                assert mine and all(a.shape[0] == pps
                                    for a in mine.values()), key
