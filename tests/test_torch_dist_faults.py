"""The port's faulted and guarded VFB² epochs on a ``torch.distributed``
device mesh (``PartyMesh(mesh=DeviceMesh)``) against the JAX package, the
ring's survivor-rank counter stream, and the fault runners over a mesh.

Two worlds of gloo ranks on the CPU, spawned once each (a ``FileStore``
under the test's temporary directory, one torch thread a rank); each runs
all of its cases and hands its results back as numpy arrays:

* ``flat``: 4 ranks, ``PartyMesh(q=4, slots=4)``, on
  ``tests/test_multidevice.py``'s data (256 × 26, ``PartyLayout.even(26,
  4, 2)``, batch 32, 8 steps) at the deep widths hidden 4, d_rep 3;
* ``packed``: 2 ranks, ``PartyMesh(q=8, slots=2)``, on
  ``tests/test_torch_mesh.py``'s data (64 × 32, q = 8), so that the
  ring's local level 1 and its level 2 across the ranks both run; its
  trace kills every party of slot 1 for two steps;
* ``data``: 4 ranks as data 2 × model 2, ``PartyMesh(q=8, slots=2,
  data_shards=2)``, on the packed world's data and traces: the faulted
  and guarded epochs run whole on each data shard, so every rank must
  give the packed world's bits.

In each world the six linear (``faulted_*``, ``guarded_*``: SGD, SVRG,
SAGA) and four deep (``deep_faulted_*``, ``deep_guarded_*``: SGD, SVRG)
epochs run under ``off``, ``two_tree`` and ``ring`` at τ = 2 on a trace
that crashes, rejoins, straggles and drops a broadcast, with base delays
that differ across the parties; the guarded epochs' trace adds a NaN and
an Inf partial.  Each is held to the JAX ``FusedEngine``'s one-device
emulation (the packed world to its ``PartyMesh(q=8, slots=2)`` engine) on
the reference's own ``_batch_indices`` schedule at 1e-5, the reference's
pin for its faulted epochs: every leaf gathered over the model group, the
rings, the counter, SAGA's table and average, and the ``HealthStats``
(``finite`` and ``alive`` exactly, the norms at 1e-5 relative).  The deep
guarded trace with a ×10³ blowup is held at ``tests/test_torch_deep_
faults.py``'s 1e-4 relative (ROADMAP C.R1).  Locality: each rank's rows
are its slot's parties', the reference's rows of them; the head's copies
are equal on every rank.

The runners: ``run_faulted_fused`` and ``run_guarded_fused`` over the
flat mesh against the port's ``mesh=None`` runner on the same inputs; a
mesh run stopped after one epoch resumes from its bundle bit for bit, and
the same bundle resumes a ``mesh=None`` run.  Without ranks: the
counter stream's Philox words against the published known answers, and
the ring's masks (``secure_agg._ring_member_mask``) over every alive
pattern of q = 8.  JAX runs only in this process, inside the fixtures;
the ranks import torch and the port alone.
"""
import itertools
import os
import pickle
import time

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, engine, faults, losses, secure_agg

ATOL, DEEP_RTOL = 1e-5, 1e-4
MODES = ("off", "two_tree", "ring")
HID, DREP, DEEP_LR, TAU = 4, 3, 0.05, 2
FLAT = dict(n=256, d=26, q=4, m=2, batch=32, steps=8, lr=0.3, lam=None)
PACKED = dict(n=64, d=32, q=8, m=2, batch=8, steps=8, lr=0.5, lam=1e-3)
CFGS = {"flat": FLAT, "packed": PACKED, "data": PACKED}
WORLDS = {"flat": 4, "packed": 2, "data": 4}
SLOTS = {"flat": 4, "packed": 2, "data": 2}
LINEAR = tuple(f"{k}_{a}" for k in ("faulted", "guarded")
               for a in ("sgd", "svrg", "saga"))
DEEP = tuple(f"deep_{k}_{a}" for k in ("faulted", "guarded")
             for a in ("sgd", "svrg"))
KINDS = LINEAR + DEEP
DATA_KINDS = ("faulted_sgd", "guarded_saga", "deep_faulted_sgd",
              "deep_guarded_svrg")
DATA_MODES = ("two_tree", "ring")
# base delays that differ across the parties (party 1 straggles by 1)
DELAYS = {4: np.array([0, 1, 2, 1]), 8: np.array([0, 1, 2, 1, 2, 0, 1, 2])}
# (step, party, kind, k, mode): a crash and its rejoin, a straggler, a
# dropped broadcast, a permanent dropout; the guarded traces a NaN and an
# Inf partial among the churn.  The packed world's crashes take all four
# parties of slot 1 at steps 5-6.
EVENTS = {
    ("flat", "faulted"): ((2, 3, "crash", 0, ""), (5, 3, "rejoin", 0, ""),
                          (3, 1, "straggle", 1, ""),
                          (4, 2, "drop_msg", 0, ""), (6, 2, "crash", 0, "")),
    ("flat", "guarded"): ((1, 1, "corrupt", 0, "nan"),
                          (3, 3, "corrupt", 0, "inf"),
                          (4, 1, "straggle", 1, ""), (5, 2, "crash", 0, ""),
                          (6, 0, "corrupt", 0, "nan"),
                          (7, 2, "rejoin", 0, "")),
    ("packed", "faulted"): ((1, 6, "crash", 0, ""), (3, 1, "straggle", 1, ""),
                            (2, 3, "drop_msg", 0, ""),
                            *((5, p, "crash", 0, "") for p in (4, 5, 7)),
                            *((7, p, "rejoin", 0, "") for p in (4, 5, 6, 7))),
    ("packed", "guarded"): ((1, 5, "corrupt", 0, "nan"),
                            (2, 2, "corrupt", 0, "inf"),
                            (3, 1, "straggle", 1, ""),
                            *((5, p, "crash", 0, "") for p in (4, 5, 6, 7)),
                            (6, 0, "corrupt", 0, "inf"),
                            *((7, p, "rejoin", 0, "") for p in (4, 5, 6, 7))),
}
# the deep guarded trace with a ×10³ blowup of party 0's partial (C.R1)
BLOWUP = EVENTS["flat", "guarded"][:4] + ((6, 0, "corrupt", 0, "blowup"),) \
    + EVENTS["flat", "guarded"][5:]
RUNNER = dict(tau=TAU, epochs=2, lr=0.3, batch=32, seed=5)
RUNNER_MODES = {"faulted": "two_tree", "guarded": "ring"}
RUNNER_STEPS = RUNNER["epochs"] * FLAT["n"] // RUNNER["batch"]
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


def _trace(pkg, q, steps, events):
    return pkg.FaultTrace(q=q, steps=steps, events=tuple(
        pkg.FaultEvent(s, p, kind, k=k, mode=mode)
        for s, p, kind, k, mode in events))


def _channels(world, kind, events=None):
    """The epoch's (q, steps) channels in the engine's party layout:
    forward and backward liveness, straggle, and (guarded) the corrupt
    codes."""
    cfg = CFGS[world]
    guarded = "guarded" in kind
    ev = events or EVENTS["packed" if world == "data" else world,
                          "guarded" if guarded else "faulted"]
    sched = _trace(faults, cfg["q"], cfg["steps"], ev).compile(cfg["m"])
    faults._check_delay_budget(DELAYS[cfg["q"]], sched, TAU)
    win = sched.epoch(0, cfg["steps"])
    rows = list(win.party_rows())
    if guarded:
        rows.append(win.corrupt_rows())
    return rows


def _lr(cfg, kind):
    return DEEP_LR if kind.startswith("deep") else cfg["lr"]


# ---------------------------------------------------------------------------
# the ranks (spawned; torch and the port only)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy().copy()


def _engine(cfg, mode, pm, x, y):
    prob = losses.logistic_l2() if cfg["lam"] is None \
        else losses.logistic_l2(cfg["lam"])
    layout = algorithms.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])
    return engine.FusedEngine(prob, x, y, layout,
                              engine.EngineConfig(secure=mode), mesh=pm,
                              device="cpu")


def _params(inputs):
    from repro_torch.core.deep_vfl import DeepVFLParams
    return DeepVFLParams(*inputs["params"])


def _run_kind(eng, cfg, kind, inputs, world, key, events=None):
    """``kind``'s epoch from the reference's start (w0 or its deep
    params; SVRG from the engine's own full gradient, SAGA from its
    ``saga_init``) at zeroed rings and step 0, on the rank's rows of the
    channels and delays.  Returns the whole results, gathered over the
    model group, and the rank's own rows of each."""
    fn = getattr(eng, f"{kind}_epoch")
    lr, idx = _lr(cfg, kind), inputs["idx"]
    loc = [eng.local(torch.from_numpy(np.asarray(a)))
           for a in (DELAYS[cfg["q"]], *_channels(world, kind, events))]
    kw = {"guard": True} if "guarded" in kind else {}
    out, mine = {}, {}
    if kind.startswith("deep"):
        pq = eng.pack_deep(_params(inputs))
        head = (pq,)
        if kind.endswith("svrg"):
            head = (pq, pq, eng.deep_full_gradient(pq, key))
        res = fn(*head, eng.deep_delay_buffers(pq, TAU), 0, *loc, lr, idx,
                 TAU, key, **kw)
        for i, a in enumerate(res[0]):
            out[f"leaf{i}"] = _np(eng.gather(a)) if i < 3 else _np(a[:1])
            mine[f"leaf{i}"] = _np(a)
        for i, r in enumerate(res[1]):
            out[f"ring{i}"], mine[f"ring{i}"] = _np(eng.gather(r)), _np(r)
        out["t"] = _np(res[2])
    else:
        wq = eng.pack_w(_w0(cfg))
        head, names = (wq,), ("w",)
        if kind.endswith("svrg"):
            head = (wq, wq, eng.full_gradient(wq, key))
        elif kind.endswith("saga"):
            head, names = (wq, *eng.saga_init(wq, key)), ("w", "tab", "avg")
        ring = torch.zeros((eng.qloc, TAU + 1, eng.dp))
        res = fn(*head, ring, 0, *loc, lr, idx, TAU, key, **kw)
        for name, a in zip(names + ("ring0", "t"), res):
            out[name] = eng.unpack_w(a) if name == "w" else _np(
                a if name == "t" else eng.gather(a))
            if name not in ("w", "t"):
                mine[name] = _np(a)
        mine["w"] = _np(res[0])
        out["wq"] = _np(eng.gather(res[0]))
    if "guarded" in kind:
        for name, a in zip(faults.HealthStats._fields, res[-1]):
            out[name], mine[name] = _np(eng.gather(a)), _np(a)
    return out, mine


def _members(pm, packed):
    """The ring's membership forms over the model group at every alive
    pattern of q = 4 (flat, ``secure_psum_ring_members_dist``) or every
    7th of 8 (packed, ``secure_psum_hier_members_dist(mode="ring")``):
    (alive, aggregate, plain survivor sum)."""
    q = pm.q
    parts = torch.arange(q * 3, dtype=torch.float32).view(q, 3) / 7 - 1
    mine = parts[list(pm.parties)]
    res = []
    pats = list(itertools.product((0.0, 1.0), repeat=q))
    for i, pat in enumerate(pats[:: 7 if packed else 1]):
        alive = torch.tensor(pat)
        key = torch.tensor([*secure_agg.key_words(9, i), i])
        if packed:
            streams = secure_agg.PartyStreams(pm.parties, pm.slot, q,
                                              pm.slots, True, "cpu").seed(9, i)
            got = secure_agg.secure_psum_hier_members_dist(
                mine, streams, alive[list(pm.parties)], pm.model_group,
                mode="ring", key=key)
        else:
            got = secure_agg.secure_psum_ring_members_dist(
                mine[0], key, alive, pm.model_group)
        res.append((pat, _np(got), _np((alive[:, None] * parts).sum(0))))
    return res


def _runners(pm, base):
    """The flat world's runners: each kind over two epochs, then a run
    stopped after one epoch (its bundle under ``base``) and resumed to
    two; returns the iterates and telemetry."""
    cfg = FLAT
    x, y = _data(cfg)
    layout = algorithms.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])
    out = {}
    for kind, mode in RUNNER_MODES.items():
        run = getattr(faults, f"run_{kind}_fused")
        tr = _trace(faults, cfg["q"], RUNNER_STEPS,
                    EVENTS["flat", kind])
        kw = dict(RUNNER, delays_q=DELAYS[4], mesh=pm, device="cpu",
                  engine_config=engine.EngineConfig(secure=mode))
        prob = losses.logistic_l2()
        out[kind, "full"] = run(prob, x, y, layout, tr, **kw)
        ck = os.path.join(base, f"ck_{kind}")
        run(prob, x, y, layout, tr, checkpoint_dir=ck,
            **dict(kw, epochs=1, horizon_epochs=2))
        out[kind, "resumed"] = run(prob, x, y, layout, tr, resume_from=ck,
                                   **kw)
    return out


def _case(world, inputs, base):
    from repro_torch.launch.mesh import make_device_mesh
    cfg = CFGS[world]
    pm = make_device_mesh(SLOTS[world], q=cfg["q"], backend="gloo",
                          device="cpu")
    x, y = _data(cfg)
    res = {"slot": pm.slot, "parties": list(pm.parties),
           "data_index": pm.data_index}
    if world == "data":
        for mode in DATA_MODES:
            eng = _engine(cfg, mode, pm, x, y)
            for kind in DATA_KINDS:
                res[mode, kind], res[mode, kind, "mine"] = _run_kind(
                    eng, cfg, kind, inputs, world, (31,))
        return res
    for mode in MODES:
        eng = _engine(cfg, mode, pm, x, y)
        for kind in KINDS:
            res[mode, kind], res[mode, kind, "mine"] = _run_kind(
                eng, cfg, kind, inputs, world, (31,))
        if world == "flat" and mode in ("off", "ring"):
            res[mode, "blowup"], res[mode, "blowup", "mine"] = _run_kind(
                eng, cfg, "deep_guarded_sgd", inputs, world, (31,),
                events=BLOWUP)
        res["xs_shape"] = tuple(eng.xs.shape)
    res["members"] = _members(pm, world == "packed")
    if world == "flat":
        res["runners"] = _runners(pm, base)
    return res


def _rank(rank, world_size, world, base):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(base, "store"),
                                     world_size),
        rank=rank, world_size=world_size)
    try:
        with open(os.path.join(base, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        res = _case(world, inputs, base)
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

def _spawn(world, base, inputs):
    import torch.multiprocessing as mp
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return mp.start_processes(_rank, args=(WORLDS[world], world, str(base)),
                              nprocs=WORLDS[world], join=False,
                              start_method="spawn")


def _join(ctx, base, size):
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a world of {size} ranks did not finish "
                               f"within {SPAWN_TIMEOUT} s")
    out = []
    for r in range(size):
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
    from repro.core import faults as jfaults
    from repro.core import losses as jloss
    from repro.sharding import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, alg=jalg, deep=jdeep,
                                 eng=jeng, faults=jfaults, loss=jloss,
                                 api=japi)


def _layout(jx, cfg):
    return jx.alg.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])


def _inputs(jx, cfg, k):
    """The reference's schedule of key k and its deep start, as numpy."""
    p = jx.deep.init_deep_vfl(jx.jax.random.PRNGKey(0), _layout(jx, cfg),
                              cfg["d"], HID, DREP)
    return {"idx": np.array(jx.alg._batch_indices(
        jx.jax.random.PRNGKey(k), cfg["n"], cfg["batch"], cfg["steps"])),
        "params": ([np.asarray(a) for a in p.enc_w1],
                   [np.asarray(a) for a in p.enc_b1],
                   [np.asarray(a) for a in p.enc_w2], np.asarray(p.head))}


def _ref_engine(jx, world, mode):
    cfg = CFGS[world]
    x, y = _data(cfg)
    prob = jx.loss.logistic_l2() if cfg["lam"] is None \
        else jx.loss.logistic_l2(cfg["lam"])
    pm = None if world == "flat" else jx.api.PartyMesh(q=8, slots=2)
    return jx.eng.FusedEngine(prob, x, y, _layout(jx, cfg),
                              jx.eng.EngineConfig(secure=mode), mesh=pm)


def _ref_kind(jx, je, world, kind, inputs, k, events=None):
    cfg = CFGS[world]
    fn = getattr(je, f"{kind}_epoch")
    key, b, s = jx.jax.random.PRNGKey(k), cfg["batch"], cfg["steps"]
    jnp = jx.jnp
    chans = [jnp.asarray(a) for a in (DELAYS[cfg["q"]],
                                      *_channels(world, kind, events))]
    kw = {"guard": True} if "guarded" in kind else {}
    t0, out = jnp.zeros((), jnp.int32), {}
    if kind.startswith("deep"):
        w1, b1, w2, head = inputs["params"]
        pq = je.pack_deep(jx.deep.DeepVFLParams(
            [jnp.asarray(a) for a in w1], [jnp.asarray(a) for a in b1],
            [jnp.asarray(a) for a in w2], jnp.asarray(head)))
        heads = (pq,)
        if kind.endswith("svrg"):
            heads = (pq, pq, je.deep_full_gradient(pq, key))
        res = fn(*heads, je.deep_delay_buffers(pq, TAU), t0, *chans,
                 _lr(cfg, kind), key, b, s, TAU, **kw)
        for i, a in enumerate(res[0]):
            out[f"leaf{i}"] = np.asarray(a) if i < 3 else np.asarray(a[:1])
        for i, r in enumerate(res[1]):
            out[f"ring{i}"] = np.asarray(r)
        out["t"] = np.asarray(res[2])
    else:
        wq = je.pack_w(_w0(cfg))
        heads, names = (wq,), ("w",)
        if kind.endswith("svrg"):
            heads = (wq, wq, je.full_gradient(wq, key))
        elif kind.endswith("saga"):
            heads, names = (wq, *je.saga_init(wq, key)), ("w", "tab", "avg")
        ring = jnp.zeros((cfg["q"], TAU + 1, int(je.xs.shape[2])))
        res = fn(*heads, ring, t0, *chans, _lr(cfg, kind), key, b, s, TAU,
                 **kw)
        for name, a in zip(names + ("ring0", "t"), res):
            out[name] = je.unpack_w(a) if name == "w" else np.asarray(a)
        out["wq"] = np.asarray(res[0])
    if "guarded" in kind:
        for name, a in zip(faults.HealthStats._fields, res[-1]):
            out[name] = np.asarray(a)
    return out


def _port_runners():
    """The flat runners on one device (``mesh=None``): uninterrupted, and
    resumed from the mesh run's bundle (filled in by the test)."""
    cfg = FLAT
    x, y = _data(cfg)
    layout = algorithms.PartyLayout.even(cfg["d"], cfg["q"], cfg["m"])
    out = {}
    for kind, mode in RUNNER_MODES.items():
        tr = _trace(faults, cfg["q"], RUNNER_STEPS,
                    EVENTS["flat", kind])
        out[kind] = dict(
            run=getattr(faults, f"run_{kind}_fused"),
            args=(losses.logistic_l2(), x, y, layout, tr),
            kw=dict(RUNNER, delays_q=DELAYS[4], device="cpu",
                    engine_config=engine.EngineConfig(secure=mode)))
        out[kind]["full"] = out[kind]["run"](*out[kind]["args"],
                                             **out[kind]["kw"])
    return out


@pytest.fixture(scope="module")
def runs(jx, tmp_path_factory):
    """Start the two worlds, compute the reference while they run, then
    collect every rank's results."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("dist_faults")
    inputs = {w: _inputs(jx, CFGS[w], 31) for w in WORLDS}
    ctxs = {w: _spawn(w, base / w, inputs[w]) for w in WORLDS}
    try:
        ref = {}
        for world in ("flat", "packed"):
            for mode in MODES:
                je = _ref_engine(jx, world, mode)
                for kind in KINDS:
                    ref[world, mode, kind] = _ref_kind(
                        jx, je, world, kind, inputs[world], 31)
                if world == "flat" and mode in ("off", "ring"):
                    ref[world, mode, "blowup"] = _ref_kind(
                        jx, je, world, "deep_guarded_sgd", inputs[world], 31,
                        events=BLOWUP)
        ref["runners"] = _port_runners()
    finally:
        got = {w: _join(ctxs[w], base / w, WORLDS[w]) for w in WORLDS}
        torch.set_num_threads(torch_threads)
    return ref, got, base


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _held(name, got, want, rel=None):
    """One result against the reference's: the health flags exactly, the
    health norms at 1e-5 relative, the rest within ``ATOL`` (or within
    ``rel`` of its norm, relative L2)."""
    got, want = np.asarray(got), np.asarray(want)
    if name in ("finite", "alive"):
        np.testing.assert_array_equal(got, want)
    elif name in ("pnorm", "gnorm"):
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=0)
    elif rel is not None:
        assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want), name
    else:
        _close(got, want)


def _match(ref, got, world, mode, kind, rel=None):
    """Every rank's gathered results the same bits and the reference's
    within tolerance; each rank's own rows the reference's rows of its
    parties."""
    ranks = got[world]
    want = ref[world, mode, kind]
    assert set(ranks[0][mode, kind]) == set(want)
    for r in ranks[1:]:
        for name, a in ranks[0][mode, kind].items():
            np.testing.assert_array_equal(r[mode, kind][name], a)
    for name, a in ranks[0][mode, kind].items():
        _held(name, a, want[name], rel)
    for r in ranks:
        for name, a in r[mode, kind, "mine"].items():
            assert a.shape[0] == len(r["parties"]), name
            full = want["wq" if name == "w" else name]
            if name == "leaf3":                 # the replicated head
                full = np.repeat(full, len(r["parties"]) * len(ranks), 0)
            _held(name, a, full[r["parties"]], rel)


# ---------------------------------------------------------------------------
# the epochs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_flat_fault_epochs_match_jax(runs, kind, mode):
    """4 ranks, one party each: the six linear and four deep faulted and
    guarded epochs against the JAX engine."""
    _match(*runs[:2], "flat", mode, kind)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_packed_fault_epochs_match_jax(runs, kind, mode):
    """2 ranks of 4 parties: the ten epochs against the JAX engine's
    packed ``PartyMesh(q=8, slots=2)`` emulation; slot 1 all dead at
    steps 5-6 (its rank enters every collective with zeros)."""
    _match(*runs[:2], "packed", mode, kind)


@pytest.mark.parametrize("mode", ("off", "ring"))
def test_deep_blowup_trace_relative(runs, mode):
    """The ×10³ blowup trace (ROADMAP C.R1): the deep guarded SGD epoch
    over the ranks within 1e-4 of each result's norm of the JAX engine,
    the telemetry's flags exact, the blowup in ``pnorm``."""
    ref, got, _ = runs
    _match(ref, got, "flat", mode, "blowup", rel=DEEP_RTOL)
    pnorm = got["flat"][0][mode, "blowup"]["pnorm"]
    assert pnorm[0, 6] > 100 * np.median(pnorm[0])


def test_guarded_quarantine_shows(runs):
    """The NaN and Inf partials are caught: ``finite`` is 0 at their
    (party, step), the quarantined party leaves ``alive`` there, and the
    iterate stays finite."""
    ref, got, _ = runs
    for world, nan_at in (("flat", ((1, 1), (3, 3), (0, 6))),
                          ("packed", ((5, 1), (2, 2), (0, 6)))):
        out = got[world][0]["ring", "guarded_sgd"]
        for p, s in nan_at:
            assert out["finite"][p, s] == 0 and out["alive"][p, s] == 0
        assert np.isfinite(out["w"]).all()


def test_packed_slot_dies_whole(runs):
    """The packed trace kills slot 1 (parties 4-7) at steps 5 and 6: its
    parties' ``alive`` telemetry is 0 there on every rank."""
    for r in runs[1]["packed"]:
        alive = r["two_tree", "guarded_sgd"]["alive"]
        assert (alive[4:, 5:7] == 0).all() and alive[0, 5] == 1


@pytest.mark.parametrize("world", ("flat", "packed"))
def test_ring_members_cancel_over_the_ranks(runs, world):
    """``secure_psum_ring_members_dist`` (flat, every alive pattern of 4)
    and the packed ``secure_psum_hier_members_dist(mode="ring")`` (local
    sub-ring, then the ring across the ranks; every 7th pattern of 8,
    all-dead slots among them): the plain survivor sum on every rank."""
    for r in runs[1][world]:
        assert len(r["members"]) >= 16
        for pat, agg, want in r["members"]:
            _close(agg, want)


@pytest.mark.parametrize("mode", DATA_MODES)
@pytest.mark.parametrize("kind", DATA_KINDS)
def test_data_axis_replicas_are_the_packed_bits(runs, kind, mode):
    """Data 2 × model 2: a faulted or guarded epoch runs whole on each
    data shard, so the two replicas of each slot agree bit for bit, and
    with the packed world's ranks (the same model group of 2, the same
    streams): every gathered result and each rank's rows."""
    got = runs[1]
    want = got["packed"][0][mode, kind]
    for rank, r in enumerate(got["data"]):
        assert (r["data_index"], r["slot"]) == divmod(rank, 2)
        for name, a in r[mode, kind].items():
            np.testing.assert_array_equal(a, want[name])
        rows = got["packed"][r["slot"]][mode, kind, "mine"]
        for name, a in r[mode, kind, "mine"].items():
            np.testing.assert_array_equal(a, rows[name])


# ---------------------------------------------------------------------------
# locality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ("flat", "packed"))
def test_rank_holds_only_its_slot(runs, world):
    """``xs``, the rings, the telemetry and every leaf hold the rank's
    slot's parties' rows only."""
    got = runs[1][world]
    cfg = CFGS[world]
    pps = cfg["q"] // SLOTS[world]
    for rank, r in enumerate(got):
        assert r["slot"] == rank
        assert r["parties"] == list(range(rank * pps, (rank + 1) * pps))
        assert r["xs_shape"][:2] == (pps, cfg["n"])
        for key, mine in r.items():
            if isinstance(key, tuple) and key[-1] == "mine":
                assert mine and all(a.shape[0] == pps
                                    for a in mine.values()), key


@pytest.mark.parametrize("world", ("flat", "packed"))
def test_head_copies_equal_on_every_rank(runs, world):
    """The replicated head: every rank's copies of it the same bits after
    each deep faulted and guarded epoch."""
    ranks = runs[1][world]
    for key in ranks[0]:
        if isinstance(key, tuple) and key[-1] == "mine" \
                and "leaf3" in ranks[0][key]:
            heads = np.concatenate([r[key]["leaf3"] for r in ranks])
            assert (heads == heads[0]).all(), key


# ---------------------------------------------------------------------------
# the runners over the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", tuple(RUNNER_MODES))
def test_runner_over_mesh_matches_one_device(runs, kind):
    """``run_{kind}_fused(mesh=...)`` on every rank: the whole iterate
    (and the gathered telemetry) within 1e-5 of the ``mesh=None``
    runner's on the same inputs."""
    ref, got, _ = runs
    want = ref["runners"][kind]["full"]
    for r in got["flat"]:
        mine = r["runners"][kind, "full"]
        if kind == "guarded":
            for name, a, b in zip(faults.HealthStats._fields, mine[1],
                                  want[1]):
                _held(name, a, b)
            mine, w = mine[0], want[0]
        else:
            w = want
        _close(mine, w)


@pytest.mark.parametrize("kind", tuple(RUNNER_MODES))
def test_runner_over_mesh_resumes_bit_for_bit(runs, kind):
    """A mesh run stopped after one epoch resumes from its bundle to the
    uninterrupted run's bits (the telemetry too), on every rank."""
    for r in runs[1]["flat"]:
        full, res = r["runners"][kind, "full"], r["runners"][kind, "resumed"]
        if kind == "guarded":
            for a, b in zip(res[1], full[1]):
                assert np.array_equal(a, b, equal_nan=True)
            full, res = full[0], res[0]
        assert np.array_equal(full, res)


@pytest.mark.parametrize("kind", tuple(RUNNER_MODES))
def test_mesh_bundle_resumes_one_device_run(runs, kind):
    """The mesh run's bundle holds the whole gathered state: the
    ``mesh=None`` runner resumes from it and ends within 1e-5 of its own
    uninterrupted run."""
    ref, _, base = runs
    case = ref["runners"][kind]
    res = case["run"](*case["args"], resume_from=str(
        base / "flat" / f"ck_{kind}"), **case["kw"])
    full = case["full"]
    if kind == "guarded":
        np.testing.assert_array_equal(res[1].finite, full[1].finite)
        res, full = res[0], full[0]
    _close(res, full)


# ---------------------------------------------------------------------------
# the ring's counter stream, without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox-4x32-10 on 16-bit limbs gives Random123's known answers."""
    got = secure_agg._philox(torch.tensor(ctr).view(4, 1), torch.tensor(key))
    assert tuple(int(v) for v in got.view(-1)) == want


def test_counter_normal_is_a_normal_stream():
    """The counter stream: deterministic, standard normal moments, rows
    and keys unrelated."""
    key = torch.tensor([*secure_agg.key_words(1, 2), 7])
    fp = torch.tensor(5)
    z = secure_agg._counter_normal(key, fp, torch.arange(4), 50_001)
    assert z.shape == (4, 50_001) and z.dtype == torch.float32
    assert torch.equal(z, secure_agg._counter_normal(key, fp, torch.arange(4),
                                                     50_001))
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    c = torch.corrcoef(z)
    assert float((c - torch.eye(4)).abs().max()) < 0.02
    other = secure_agg._counter_normal(key + torch.tensor([0, 0, 1]), fp,
                                       torch.arange(1), 64)
    assert not torch.equal(other, z[:1, :64])


ALIVE8 = [p for p in itertools.product((0, 1), repeat=8) if any(p)]


def test_ring_member_masks_cancel_over_every_alive_pattern():
    """For every non-empty alive pattern of q = 8, the survivors' masks
    sum to 0 within f32 rounding, and a lone survivor's is exactly 0."""
    key = torch.tensor([*secure_agg.key_words(3, 4), 11])
    for pat in ALIVE8:
        av = torch.tensor(pat, dtype=torch.float32)
        m = secure_agg._ring_member_mask(key, av, torch.arange(8), (5, 2))
        assert m.shape == (8, 5, 2)
        total = (av.view(8, 1, 1) * m).sum(0)
        assert float(total.abs().max()) < 1e-5, pat
        if sum(pat) == 1:
            assert float(m[pat.index(1)].abs().max()) == 0.0
        else:                           # every survivor masks its value
            assert all(float(m[i].abs().min()) > 0
                       for i in range(8) if pat[i]), pat


def test_ring_member_draws_only_its_two_rows(monkeypatch):
    """Member i of survivor rank r draws rows r and (r − 1) mod n_alive
    of the stream, no other, at the alive vector's fingerprint."""
    drawn = []
    real = secure_agg._counter_normal

    def spy(key, fp, rows, numel):
        drawn.append((int(fp), rows.tolist()))
        return real(key, fp, rows, numel)

    monkeypatch.setattr(secure_agg, "_counter_normal", spy)
    key = torch.tensor([*secure_agg.key_words(3, 4), 11])
    for pat in ALIVE8[::5]:
        av = torch.tensor(pat, dtype=torch.float32)
        n = sum(pat)
        fp = int(secure_agg._alive_fingerprint(av.long()))
        for i in range(8):
            drawn.clear()
            secure_agg._ring_member_mask(key, av, torch.tensor([i]), (3,))
            r = sum(pat[:i])
            assert drawn == [(fp, [r, (r - 1) % n])], (pat, i)


def test_ring_masks_rekey_on_membership():
    """Member 0 holds survivor rank 0 in both {0, 1, 2} and {0, 1, 3}, yet
    its mask differs: the alive set's fingerprint keys the stream."""
    key = torch.tensor([*secure_agg.key_words(3, 4), 11])
    a = torch.tensor([1.0, 1, 1, 0, 0, 0, 0, 0])
    b = torch.tensor([1.0, 1, 0, 1, 0, 0, 0, 0])
    ma = secure_agg._ring_member_mask(key, a, torch.tensor([0]), (16,))
    mb = secure_agg._ring_member_mask(key, b, torch.tensor([0]), (16,))
    assert not torch.allclose(ma, mb)
    step = secure_agg._ring_member_mask(key + torch.tensor([0, 0, 1]), a,
                                        torch.tensor([0]), (16,))
    assert not torch.allclose(ma, step)
