"""The port's party mesh on a ``torch.distributed`` device mesh
(``PartyMesh(mesh=DeviceMesh)``) against the JAX package.

Three worlds of gloo ranks on the CPU, spawned once each (a ``FileStore``
under the test's temporary directory, one torch thread a rank); each runs
all of its cases and hands its results back as numpy arrays:

* ``flat``: 4 ranks, ``PartyMesh(q=4, slots=4)``, the case of
  ``tests/test_multidevice.py`` (256 × 26 data, ``PartyLayout.even(26, 4,
  2)``, ``logistic_l2``, lr 0.3, batch 32, 8 steps): SGD, SVRG and SAGA
  (with ``full_gradient`` and ``saga_init``) under ``off``,
  ``two_tree``, ``two_tree`` with ``schedule_faithful`` and ``ring``;
  the multi-dominator, pipelined and multi-dominator pipelined forms
  under ``two_tree`` and ``ring``; a ``ServeEngine`` answering full, hit
  and delta requests; BUM's ``secure_vfl_reduce`` over the 4 ranks; the
  membership form; the errors;
* ``packed``: 2 ranks, ``PartyMesh(q=8, slots=2)``: SGD, SVRG and SAGA
  under the four modes; the two-level membership form;
* ``data``: 4 ranks as data 2 × model 2, ``PartyMesh(q=8, slots=2,
  data_shards=2)`` and ``PartyMesh(q=2, slots=2, data_shards=2)``: fresh
  SGD and SVRG, as ``tests/test_hierarchical.py`` runs them.

Each epoch runs on the reference's own ``_batch_indices`` schedule and is
held to the JAX ``FusedEngine``'s one-device emulation (identical in
collective semantics to ``shard_map``) at 1e-5 absolute.  Locality: a
rank's ``xs`` holds only its slot's parties, and its mask generators
reproduce its own parties' streams and no other slot's, the ring's r_prev
being the one exception.  JAX runs only in this process, inside the
fixtures; the ranks import torch and the port alone.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

from repro_torch.core import secure_agg

MODES = {"off": dict(secure="off"), "two_tree": dict(secure="two_tree"),
         "faithful": dict(secure="two_tree", schedule_faithful=True),
         "ring": dict(secure="ring")}
ALGOS = ("sgd", "svrg", "saga")
ATOL = 1e-5
# flat: tests/test_multidevice.py's engine case
FLAT = dict(n=256, d=26, q=4, m=2, batch=32, steps=8, lr=0.3, lam=None)
# packed and data: tests/test_torch_mesh.py's sizes
SMALL = dict(n=64, d=32, q=8, m=2, batch=8, steps=8, lr=0.5, lam=1e-3)
FLAT_KINDS = ("multi_sgd", "multi_svrg", "multi_saga", "pipelined_sgd",
              "pipelined_svrg", "pipelined_saga", "multi_pipelined_sgd",
              "multi_pipelined_svrg", "multi_pipelined_saga")
DATA_SHAPES = ((8, 2), (2, 2))             # (q, slots), data_shards 2
DATA_CASES = [(s, m, a) for s in DATA_SHAPES
              for m, a in (("off", "sgd"), ("two_tree", "sgd"),
                           ("ring", "sgd"), ("off", "svrg"),
                           ("two_tree", "svrg"))]
WORLDS = {"flat": 4, "packed": 2, "data": 4}
STREAM_KEY = (77, 5)
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


def _doms(kind, cfg):
    return cfg["m"] if kind.startswith("multi") else 1


# ---------------------------------------------------------------------------
# the ranks (spawned; torch and the port only)
# ---------------------------------------------------------------------------

def _port_problem(cfg):
    from repro_torch.core import losses
    return losses.logistic_l2() if cfg["lam"] is None \
        else losses.logistic_l2(cfg["lam"])


def _engine(cfg, mode, pm):
    from repro_torch.core import algorithms, engine
    x, y = _data(cfg)
    layout = algorithms.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])
    return engine.FusedEngine(_port_problem(cfg), x, y, layout,
                              engine.EngineConfig(**MODES[mode]), mesh=pm,
                              device="cpu")


def _np(t):
    return t.detach().cpu().numpy().copy()


def _epoch(eng, kind, wq, idx, key, lr):
    """Run ``kind``'s epoch from ``wq`` (SVRG from its own full gradient,
    SAGA from its own ``saga_init``); returns named whole tensors."""
    algo = kind.rsplit("_", 1)[-1]
    fn = getattr(eng, f"{kind}_epoch")
    out = {}
    if algo == "sgd":
        w = fn(wq, lr, idx, key)
    elif algo == "svrg":
        mu = eng.full_gradient(wq, key)
        out["mu"] = _np(eng.gather(mu))
        w = fn(wq, wq, mu, lr, idx, key)
    else:
        tab, avg = eng.saga_init(wq, key)
        out["tab0"], out["avg0"] = _np(eng.gather(tab)), _np(eng.gather(avg))
        w, tab, avg = fn(wq, tab, avg, lr, idx, key)
        out["tab"], out["avg"] = _np(eng.gather(tab)), _np(eng.gather(avg))
    out["w"] = eng.unpack_w(w)
    return out


def _streams_record(eng):
    """The rank's stream identities and each stream's first draw after a
    re-seed from ``STREAM_KEY``."""
    streams = eng._reseed(*STREAM_KEY)
    return dict(ids=list(streams.identities),
                draws=[_np(torch.randn(8, generator=g))
                       for g in streams.generators()])


def _serve_trace(eng, cfg):
    """The reference serve test's trace: cold (chunked), hits, an update
    then a delta, a full mix, two versions behind, hits.  Returns the
    answers, the final stats and how often this rank ran the dominator's
    matvec."""
    import dataclasses

    from repro_torch.serve.engine import ServeEngine
    sv = ServeEngine(eng, max_batch=16, device="cpu")
    calls, dom = [], sv._dominator

    def counted(fn):
        def f():
            calls.append(1)
            return fn()
        return dom(f)

    sv._dominator = counted
    w0, hot, out = _w0(cfg), np.array([3, 3, 9, 17, 39]), []
    sv.set_weights(w0)
    for step in (np.arange(40), hot, np.array([0, 39, 3]), "u1", hot,
                 np.array([3, 50, 9]), "u2", "u3", np.array([0, 1]),
                 np.array([0, 1])):
        if isinstance(step, str):
            sv.set_weights(w0 * {"u1": 1.01, "u2": 1.1, "u3": 1.2}[step]
                           + (0.02 if step == "u1" else 0.0))
        else:
            out.append(sv.serve(step))
    return dict(out=out, stats=dataclasses.asdict(sv.stats),
                dominator_calls=len(calls), dispatches=sv.stats.dispatches)


def _errors(dm, eng, cfg, idx):
    """Each call that must raise, and what it raised."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.api import PartyMesh
    q, dp = cfg["q"], eng.dp
    wq = eng.pack_w(_w0(cfg))
    z = torch.zeros(eng.qloc, 3, dp)
    pq = (torch.zeros(eng.qloc, dp, 2), torch.zeros(eng.qloc, 2),
          torch.zeros(eng.qloc, 2, 2), torch.zeros(eng.qloc, 2))
    # a fault trace's channels (forward and backward liveness, straggle,
    # corrupt codes), whole (q, steps) and the rank's (qloc, steps) rows
    chan = (np.ones((q, len(idx))), np.ones((q, len(idx))),
            np.zeros((q, len(idx))), np.zeros((q, len(idx))))
    mine = tuple(eng.local(torch.from_numpy(a)) for a in chan)
    rings = eng.deep_delay_buffers(pq, 2)
    calls = {
        "model_size": lambda: PartyMesh(q=q, slots=2, mesh=dm),
        "data_size": lambda: PartyMesh(q=q, slots=q, data_shards=2,
                                       mesh=dm),
        "pods": lambda: PartyMesh(q=q, slots=q, pods=2, mesh=dm),
        # whole channels, a whole ring, whole rings, whole delays fed to a
        # rank that holds qloc rows
        "guarded": lambda: eng.guarded_sgd_epoch(
            wq, z, 0, [0] * eng.qloc, *chan, 0.1, idx, 2),
        "faulted": lambda: eng.faulted_sgd_epoch(
            wq, torch.zeros(q, 3, dp), 0, [0] * eng.qloc, *mine[:3], 0.1,
            idx, 2),
        "deep_faulted": lambda: eng.deep_faulted_sgd_epoch(
            pq, tuple(torch.zeros(q, *r.shape[1:]) for r in rings), 0,
            [0] * eng.qloc, *mine[:3], 0.1, idx, 2),
        "deep_guarded": lambda: eng.deep_guarded_sgd_epoch(
            pq, rings, 0, [0] * q, *mine, 0.1, idx, 2),
        "tracing": lambda: eng.sgd_epoch_graph(wq, 0.1, idx),
        "serve_probe": lambda: ServeEngine(eng, device="cpu")
        .serve_full_graph(),
        "nccl_backend": lambda: make_device_mesh(q, backend="nccl",
                                                 device="cpu"),
        "cuda_device": lambda: make_device_mesh(q, backend="gloo",
                                                device="cuda"),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = None
        except Exception as e:          # recorded, checked by the test
            out[name] = (type(e).__name__, str(e))
    return out


def _bum(pm):
    """BUM over the model group: 4 ranks' partials r·1 (8,), forward
    and gradient of the sum, per variant."""
    from repro_torch.core.bum import secure_vfl_reduce
    out = {}
    for name, mode, faithful in (("two_tree", "two_tree", False),
                                 ("faithful", "two_tree", True),
                                 ("ring", "ring_masks", False)):
        streams = secure_agg.PartyStreams(pm.parties, pm.slot, pm.q,
                                          pm.slots, True, "cpu").seed(3)
        part = torch.full((8,), float(pm.slot), requires_grad=True)
        agg = secure_vfl_reduce(part, streams.own[0], 1.0, faithful, mode,
                                group=pm.model_group, gen_prev=streams.prev)
        agg.sum().backward()
        out[name] = (_np(agg), _np(part.grad))
    return out


def _members(pm, packed):
    """The membership forms over the model group at every alive pattern
    of q = 4 (flat) or 8 (packed, each rank's 4 parties): (alive,
    aggregate, plain survivor sum)."""
    import itertools
    q = pm.q
    parts = torch.arange(q * 3, dtype=torch.float32).view(q, 3) / 7 - 1
    mine = parts[list(pm.parties)]
    res = []
    pats = list(itertools.product((0.0, 1.0), repeat=q))
    for i, pat in enumerate(pats[:: 17 if packed else 1]):
        alive = torch.tensor(pat)
        streams = secure_agg.PartyStreams(pm.parties, pm.slot, q, pm.slots,
                                          False, "cpu").seed(9, i)
        if packed:
            got = secure_agg.secure_psum_hier_members_dist(
                mine, streams, alive[list(pm.parties)], pm.model_group)
        else:
            got = secure_agg.secure_psum_members_dist(
                mine[0], streams.own[0], alive[pm.slot], pm.model_group)
        res.append((pat, _np(got), _np((alive[:, None] * parts).sum(0))))
    return res


def _case_flat(inputs):
    from repro_torch.launch.mesh import make_device_mesh
    cfg = FLAT
    pm = make_device_mesh(cfg["q"], backend="gloo", device="cpu")
    res = {"slot": pm.slot, "parties": list(pm.parties),
           "data_index": pm.data_index}
    for mode in MODES:
        eng = _engine(cfg, mode, pm)
        wq = eng.pack_w(_w0(cfg))
        kinds = ALGOS + (FLAT_KINDS if mode in ("two_tree", "ring") else ())
        for kind in kinds:
            res[mode, kind] = _epoch(eng, kind, wq,
                                     inputs[_doms(kind, cfg)], (21,),
                                     cfg["lr"])
        res[mode, "objective"] = eng.objective(wq)
        if mode != "faithful":
            res[mode, "serve"] = _serve_trace(eng, cfg)
        if mode in ("two_tree", "ring"):
            res[mode, "streams"] = _streams_record(eng)
        if mode == "off":
            res["xs_shape"] = tuple(eng.xs.shape)
            res["errors"] = _errors(pm.mesh, eng, cfg, inputs[1])
    res["bum"] = _bum(pm)
    res["members"] = _members(pm, False)
    return res


def _case_packed(inputs):
    from repro_torch.launch.mesh import make_device_mesh
    cfg = SMALL
    pm = make_device_mesh(2, q=cfg["q"], backend="gloo", device="cpu")
    res = {"slot": pm.slot, "parties": list(pm.parties)}
    for mode in MODES:
        eng = _engine(cfg, mode, pm)
        wq = eng.pack_w(_w0(cfg))
        for kind in ALGOS:
            res[mode, kind] = _epoch(eng, kind, wq, inputs[1], (21,),
                                     cfg["lr"])
        if mode in ("two_tree", "ring"):
            res[mode, "streams"] = _streams_record(eng)
        res["xs_shape"] = tuple(eng.xs.shape)
    res["members"] = _members(pm, True)
    return res


def _case_data(inputs):
    from repro_torch.core import algorithms, engine
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.api import PartyMesh
    cfg = SMALL
    pm = make_device_mesh(2, q=8, backend="gloo", device="cpu")
    res = {"slot": pm.slot, "data_index": pm.data_index}
    x, y = _data(cfg)
    for (q, slots), mode, algo in DATA_CASES:
        mesh = PartyMesh(q=q, slots=slots, data_shards=2, mesh=pm.mesh)
        eng = engine.FusedEngine(
            _port_problem(cfg), x, y,
            algorithms.PartyLayout.even(cfg["d"], q, 1 if q == 2 else 2),
            engine.EngineConfig(**MODES[mode]), mesh=mesh, device="cpu")
        res[(q, slots), mode, algo] = _epoch(
            eng, algo, eng.pack_w(_w0(cfg)), inputs[1], (41,), cfg["lr"])
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
        res = {"flat": _case_flat, "packed": _case_packed,
               "data": _case_data}[kind](inputs)
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
    while not ctx.join(timeout=5):
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
    from repro.core import algorithms as jalg
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    from repro.serve import ServeEngine
    from repro.sharding import api as japi
    return types.SimpleNamespace(jax=jax, alg=jalg, eng=jeng, loss=jloss,
                                 api=japi, serve=ServeEngine)


def _key(jx, k):
    return jx.jax.random.PRNGKey(k)


def _schedules(jx, cfg, k):
    """The reference's (steps, doms·batch) schedules of key k, by doms."""
    return {d: np.array(jx.alg._batch_indices(
        _key(jx, k), cfg["n"], d * cfg["batch"], cfg["steps"]))
        for d in (1, cfg["m"])}


def _ref_engine(jx, cfg, mode, q=None, pm=None):
    x, y = _data(cfg)
    q = cfg["q"] if q is None else q
    prob = jx.loss.logistic_l2() if cfg["lam"] is None \
        else jx.loss.logistic_l2(cfg["lam"])
    lay = jx.alg.PartyLayout.even(cfg["d"], q, 1 if q == 2 else cfg["m"])
    return jx.eng.FusedEngine(prob, x, y, lay,
                              jx.eng.EngineConfig(**MODES[mode]),
                              mesh=None if pm is None
                              else jx.api.PartyMesh(**pm))


def _ref_epoch(jx, je, cfg, kind, k):
    algo = kind.rsplit("_", 1)[-1]
    fn = getattr(je, f"{kind}_epoch")
    key, lr, b, s = _key(jx, k), cfg["lr"], cfg["batch"], cfg["steps"]
    wq = je.pack_w(_w0(cfg))
    out = {}
    if algo == "sgd":
        w = fn(wq, lr, key, b, s)
    elif algo == "svrg":
        mu = je.full_gradient(wq, key)
        out["mu"] = np.asarray(mu)
        w = fn(wq, wq, mu, lr, key, b, s)
    else:
        tab, avg = je.saga_init(wq, key)
        out["tab0"], out["avg0"] = np.asarray(tab), np.asarray(avg)
        w, tab, avg = fn(wq, tab, avg, lr, key, b, s)
        out["tab"], out["avg"] = np.asarray(tab), np.asarray(avg)
    out["w"] = je.unpack_w(w)
    return out


def _ref_serve(jx, cfg, mode):
    """The reference's answers and stats over the serve trace."""
    import dataclasses
    sv = jx.serve(_ref_engine(jx, cfg, mode), max_batch=16)
    w0, hot, out = _w0(cfg), np.array([3, 3, 9, 17, 39]), []
    sv.set_weights(w0)
    for step in (np.arange(40), hot, np.array([0, 39, 3]), "u1", hot,
                 np.array([3, 50, 9]), "u2", "u3", np.array([0, 1]),
                 np.array([0, 1])):
        if isinstance(step, str):
            sv.set_weights(w0 * {"u1": 1.01, "u2": 1.1, "u3": 1.2}[step]
                           + (0.02 if step == "u1" else 0.0))
        else:
            out.append(np.asarray(sv.serve(step)))
    return dict(out=out, stats=dataclasses.asdict(sv.stats))


@pytest.fixture(scope="module")
def runs(jx, tmp_path_factory):
    """Start the three worlds, compute the reference while they run, then
    collect every rank's results."""
    base = tmp_path_factory.mktemp("dist_mesh")
    inputs = {"flat": _schedules(jx, FLAT, 21),
              "packed": _schedules(jx, SMALL, 21),
              "data": _schedules(jx, SMALL, 41)}
    ctxs = {kind: _spawn(kind, base / kind, inputs[kind])
            for kind in WORLDS}
    try:
        ref = {}
        for mode in MODES:
            je = _ref_engine(jx, FLAT, mode)
            for kind in ALGOS + (FLAT_KINDS if mode in ("two_tree", "ring")
                                 else ()):
                ref["flat", mode, kind] = _ref_epoch(jx, je, FLAT, kind, 21)
            if mode != "faithful":
                ref["flat", mode, "serve"] = _ref_serve(jx, FLAT, mode)
            je = _ref_engine(jx, SMALL, mode, pm=dict(q=8, slots=2))
            for kind in ALGOS:
                ref["packed", mode, kind] = _ref_epoch(jx, je, SMALL, kind,
                                                       21)
        for (q, slots), mode, algo in DATA_CASES:
            je = _ref_engine(jx, SMALL, mode, q=q,
                             pm=dict(q=q, slots=slots, data_shards=2))
            ref["data", (q, slots), mode, algo] = _ref_epoch(
                jx, je, SMALL, algo, 41)
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


# ---------------------------------------------------------------------------
# the epochs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("mode", list(MODES))
def test_flat_epochs_match_jax(runs, mode, algo):
    """4 ranks, one party each: the epoch's iterate, SVRG's full gradient
    and SAGA's table and average (initial and final) against the
    reference, the same on every rank."""
    ref, got = runs
    _same_on_every_rank(got["flat"], (mode, algo))
    want = ref["flat", mode, algo]
    for name, a in got["flat"][0][mode, algo].items():
        _close(a, want[name])


@pytest.mark.parametrize("mode", ("two_tree", "ring"))
@pytest.mark.parametrize("kind", FLAT_KINDS)
def test_flat_multi_and_pipelined_match_jax(runs, kind, mode):
    ref, got = runs
    _same_on_every_rank(got["flat"], (mode, kind))
    want = ref["flat", mode, kind]
    for name, a in got["flat"][0][mode, kind].items():
        _close(a, want[name])


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("mode", list(MODES))
def test_packed_epochs_match_jax(runs, mode, algo):
    """2 ranks of 4 parties: the two-level aggregation, level 2 over the
    ranks, against the reference's ``PartyMesh(q=8, slots=2)``."""
    ref, got = runs
    _same_on_every_rank(got["packed"], (mode, algo))
    want = ref["packed", mode, algo]
    for name, a in got["packed"][0][mode, algo].items():
        _close(a, want[name])


@pytest.mark.parametrize("shape,mode,algo", DATA_CASES)
def test_data_axis_epochs_match_jax(runs, shape, mode, algo):
    """Data 2 × model 2: each rank's slice of the minibatch, the gradient
    summed over the data group, every rank's iterate the reference's
    and the same bits on all four."""
    ref, got = runs
    _same_on_every_rank(got["data"], (shape, mode, algo))
    want = ref["data", shape, mode, algo]
    for name, a in got["data"][0][shape, mode, algo].items():
        _close(a, want[name])


def test_objective_over_the_ranks(runs):
    """``objective`` sums the ranks' partials and regularisers: the
    one-device objective of the gathered iterate."""
    from repro_torch.core import algorithms, engine, losses
    x, y = _data(FLAT)
    eng = engine.FusedEngine(losses.logistic_l2(), x, y,
                             algorithms.PartyLayout.even(26, 4, 2),
                             device="cpu")
    want = eng.objective(eng.pack_w(_w0(FLAT)))
    for r in runs[1]["flat"]:
        for mode in MODES:
            assert abs(r[mode, "objective"] - want) < 1e-6


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("off", "two_tree", "ring"))
def test_serve_over_ranks_matches_jax(runs, mode):
    """Full, hit and delta requests: every answer and every
    ``ServeStats`` field as the reference's, on every rank; the
    dominator's matvec ran on the rank of party 0 only, once a
    dispatch."""
    ref, got = runs
    want = ref["flat", mode, "serve"]
    for r in got["flat"]:
        mine = r[mode, "serve"]
        assert mine["stats"] == want["stats"]
        assert want["stats"]["delta_dispatches"] == 1
        assert want["stats"]["hit_dispatches"] == 3
        for a, b in zip(mine["out"], want["out"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert mine["dominator_calls"] == (
            mine["dispatches"] if 0 in r["parties"] else 0)


# ---------------------------------------------------------------------------
# locality: a rank's columns and its mask streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ("flat", "packed"))
def test_rank_holds_only_its_slot(runs, world):
    got = runs[1][world]
    cfg = FLAT if world == "flat" else SMALL
    pps = cfg["q"] // len(got)
    x, _ = _data(cfg)
    for rank, r in enumerate(got):
        assert r["slot"] == rank
        assert r["parties"] == list(range(rank * pps, (rank + 1) * pps))
        assert r["xs_shape"][0] == pps
        assert r["xs_shape"][1] == cfg["n"]


@pytest.mark.parametrize("mode", ("two_tree", "ring"))
@pytest.mark.parametrize("world", ("flat", "packed"))
def test_rank_draws_only_its_own_streams(runs, world, mode):
    """Each rank's generators reproduce its own parties' streams (and its
    slot's level-2 stream when packed), no other party's or slot's, the
    ring's r_prev alone excepted."""
    got = runs[1][world]
    q, slots = (4, 4) if world == "flat" else (8, 2)
    pps = q // slots
    universe = [(secure_agg._L1_SALT, p) for p in range(q)] \
        + ([(secure_agg._L2_SALT, s) for s in range(slots)] if q > slots
           else [])
    draw = {i: torch.randn(8, generator=secure_agg.mask_generator(
        *STREAM_KEY, *i, device="cpu")).numpy() for i in universe}
    for rank, r in enumerate(got):
        rec = r[mode, "streams"]
        ids = [tuple(i) for i in rec["ids"]]
        own = [(secure_agg._L1_SALT, p)
               for p in range(rank * pps, (rank + 1) * pps)]
        if q > slots:
            own.append((secure_agg._L2_SALT, rank))
        prev = [] if mode != "ring" else (
            [(secure_agg._L2_SALT, (rank - 1) % slots)] if q > slots
            else [(secure_agg._L1_SALT, (rank - 1) % q)])
        assert ids == own + prev
        for i, d in zip(ids, rec["draws"]):
            np.testing.assert_array_equal(d, draw[i])
        for other in universe:
            if other not in ids:
                assert not any(np.array_equal(d, draw[other])
                               for d in rec["draws"]), other


def test_partymesh_places_each_rank(runs):
    """``slot``, ``parties`` and ``data_index`` from the mesh's
    coordinates: data 2 × model 2 puts rank r at (r // 2, r % 2)."""
    for rank, r in enumerate(runs[1]["data"]):
        assert (r["data_index"], r["slot"]) == divmod(rank, 2)
    for rank, r in enumerate(runs[1]["flat"]):
        assert (r["data_index"], r["slot"]) == (0, rank)


# ---------------------------------------------------------------------------
# BUM and the membership forms over the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ("two_tree", "faithful", "ring"))
def test_bum_over_ranks(runs, variant):
    """``secure_vfl_reduce`` over 4 ranks (partials 0, 1, 2, 3): the
    forward is the plain sum at 1e-4 and each rank's gradient is ϑ = 1 at
    1e-5 (``tests/test_multidevice.py``'s check)."""
    for r in runs[1]["flat"]:
        agg, grad = r["bum"][variant]
        _close(agg, np.full(8, 6.0), 1e-4)
        _close(grad, np.ones(8), 1e-5)


@pytest.mark.parametrize("world", ("flat", "packed"))
def test_membership_forms_cancel_over_the_survivors(runs, world):
    """``secure_psum_members_dist`` (flat, every alive pattern of 4) and
    ``secure_psum_hier_members_dist`` (2 slots of 4, every 17th pattern
    of 8, all-dead slots among them): the plain survivor sum on every
    rank."""
    for r in runs[1][world]:
        assert len(r["members"]) >= 16
        for pat, got, want in r["members"]:
            _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,exc,match", [
    ("model_size", "ValueError", "'model' dimension of size 2"),
    ("data_size", "ValueError", "'data' dimension of size 2"),
    ("pods", "ValueError", "'pod' dimension of size 2"),
    ("guarded", "ValueError", r"fault channels \(4, 8\) != \(party rows"),
    ("faulted", "ValueError", "bufq holds 4 party rows; this engine holds 1"),
    ("deep_faulted", "ValueError",
     "bufq holds 4 party rows; this engine holds 1"),
    ("deep_guarded", "ValueError",
     "delays holds 4 party rows; this engine holds 1"),
    ("tracing", "NotImplementedError", "A17b3"),
    ("serve_probe", "NotImplementedError", "A17b3"),
    ("nccl_backend", "ValueError", "not the requested 'nccl'"),
    ("cuda_device", "RuntimeError", "is_available"),
])
def test_device_mesh_errors(runs, name, exc, match):
    """A mesh whose model or data size is not the ``PartyMesh``'s raises
    ``ValueError``; a faulted or guarded epoch fed whole (q, ...)
    channels, rings or delays on a rank of qloc rows raises
    ``ValueError``; an entry point outside the slice raises
    ``NotImplementedError`` naming its ROADMAP item; a device mesh is
    never built on another backend or device than the one asked for."""
    import re
    for r in runs[1]["flat"]:
        got = r["errors"][name]
        assert got is not None and got[0] == exc, got
        assert re.search(match, got[1]), got
