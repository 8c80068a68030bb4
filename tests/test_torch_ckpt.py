"""The port's checkpoints and divergence supervisor against the JAX package.

* ``checkpoint.ckpt`` round trips, bit for bit, with tensor and numpy
  leaves; a tree of dicts, lists, tuples, ``None`` and a ``NamedTuple``
  saved by ``repro.checkpoint.ckpt`` loads in the port, and the reverse,
  with identical leaves and an identical ``treedef`` string;
* the retention ring (``keep_last``, ``None``, invalid), ``discard_after``,
  ``step=`` loads, the legacy ``checkpoint.npz`` and ``arrays.npz`` +
  ``manifest.json`` layouts, and the shape, key and treedef
  ``ValueError``s;
* a run killed right after a checkpoint lands resumes bit for bit the
  uninterrupted run: ``train`` on both engines × SGD/SAGA, deep ``train``
  on both engines;
* the step-2 bundle of a 4-epoch run equals a 2-epoch run's (the
  supervisor's rollback target);
* the supervisor's pure functions against the reference's on the same
  inputs; ``train(supervise=True)`` heals a divergent ridge run, leaves a
  clean run bit for bit the unsupervised one and turns an unhealable run
  into ``DivergenceError``; ``supervised_guarded_run`` escalates the guard
  after a poisoned aggregate and tightens τ on a delay-correlated spike.

Sizes are those of ``tests/test_supervisor.py``: n = 48, d = 12 over
q = 4 parties with m = 2, batch 8 (6 steps an epoch).  JAX is imported
inside module-scoped fixtures.
"""
import json
import os
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import algorithms, faults, losses, supervisor
from repro_torch.core.supervisor import (DivergenceError, SupervisorConfig,
                                         supervised_guarded_run)

TAU, BATCH, STEPS = 2, 8, 6


class Pair(NamedTuple):
    first: object
    second: object


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(48, 12)).astype(np.float32)
    y = (rng.random(48) > 0.5).astype(np.float32) * 2 - 1
    return x, y


@pytest.fixture(scope="module")
def layout():
    return algorithms.PartyLayout.even(12, 4, 2)


@pytest.fixture(scope="module")
def jx():
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro.core import faults as jfaults
    from repro.core import supervisor as jsup
    return types.SimpleNamespace(jax=jax, ckpt=jckpt, faults=jfaults,
                                 sup=jsup)


def _trees(rng, health):
    """Trees of every node kind the bundles carry, ``health`` the
    ``HealthStats`` class of the package that builds the tree."""
    def a(*shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    return {
        "mixed": {"pt": ([a(3, 2), a(2)], (a(4),), a(1)), "b": None,
                  "c": {"x": a(2, 2), "nested": [None, {"z": a(3)}]}},
        "state": {"wq": a(4, 3), "t0": np.asarray(7, np.int64),
                  "objs": np.array([0.5, np.nan, np.nan]),
                  "health": health(*(a(4, 6) for _ in range(4)))},
        "namedtuple": Pair(a(2), Pair(np.arange(5, dtype=np.int32), None)),
        "leaf": a(3, 3, dtype=np.float64),
    }


def _assert_same(got, want):
    """Same structure, leaves equal bit for bit with the same dtype."""
    gl, gdef = ckpt.flatten_with_path(got)
    wl, wdef = ckpt.flatten_with_path(want)
    assert gdef == wdef
    assert [k for k, _ in gl] == [k for k, _ in wl]
    for (k, g), (_, w) in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixed", "state", "namedtuple", "leaf"])
def test_flattener_renders_as_jax(jx, name):
    tree = _trees(np.random.default_rng(0), jx.faults.HealthStats)[name]
    leaves, treedef = ckpt.flatten_with_path(tree)
    assert treedef == str(jx.jax.tree_util.tree_structure(tree))
    assert [k for k, _ in leaves] == [
        jx.jax.tree_util.keystr(kp) for kp, _ in
        jx.jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", ["mixed", "state", "namedtuple", "leaf"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_bundles_load_in_either_package(jx, tmp_path, name, saver):
    """A tree saved by one package loads in the other bit for bit, with
    the treedef string the loader compares equal to its own."""
    rng = np.random.default_rng(1)
    jtree = _trees(rng, jx.faults.HealthStats)[name]
    ttree = _trees(np.random.default_rng(1), faults.HealthStats)[name]
    path = str(tmp_path / "ck")
    if saver == "jax":
        jx.ckpt.save_checkpoint(path, jtree, step=3)
        got = ckpt.load_checkpoint(path, ttree)
        want = ttree
    else:
        ckpt.save_checkpoint(path, ttree, step=3)
        got = jx.jax.tree_util.tree_map(
            np.asarray, jx.ckpt.load_checkpoint(path, jtree))
        want = jtree
    manifest = json.loads(bytes(np.load(
        ckpt.latest_checkpoint(path))["__manifest__"]).decode())
    assert manifest["treedef"] == ckpt.flatten_with_path(ttree)[1] \
        == str(jx.jax.tree_util.tree_structure(jtree))
    assert manifest["step"] == ckpt.checkpoint_step(path) \
        == jx.ckpt.checkpoint_step(path) == 3
    if name == "namedtuple":
        assert type(got).__name__ == "Pair"
    _assert_same(got, want)


def test_round_trip_tensor_leaves(tmp_path):
    """Tensor leaves go to numpy on save; a load casts each leaf to its
    template's dtype (int64 counter, float64 objectives) bit for bit."""
    tree = {"wq": torch.randn(4, 3), "t0": torch.tensor(11),
            "objs": np.array([1.5, np.nan]),
            "pq": (torch.randn(2, 5, dtype=torch.float64), None)}
    path = str(tmp_path / "rt")
    ckpt.save_checkpoint(path, tree, step=1)
    got = ckpt.load_checkpoint(path, tree)
    assert isinstance(got["wq"], np.ndarray) and got["pq"][1] is None
    assert got["t0"].dtype == np.int64 and int(got["t0"]) == 11
    np.testing.assert_array_equal(got["wq"], tree["wq"].numpy())
    np.testing.assert_array_equal(got["pq"][0], tree["pq"][0].numpy())
    np.testing.assert_array_equal(got["objs"], tree["objs"])
    like = dict(tree, wq=torch.zeros(4, 3, dtype=torch.float64))
    assert ckpt.load_checkpoint(path, like)["wq"].dtype == np.float64


def test_retention_ring_and_step_loads(tmp_path):
    path = str(tmp_path / "ring")
    tree = {"w": np.arange(4, dtype=np.float32)}
    for s in range(1, 6):
        ckpt.save_checkpoint(path, {"w": tree["w"] + s}, step=s,
                             keep_last=3)
    assert ckpt.checkpoint_steps(path) == [3, 4, 5]
    assert ckpt.latest_checkpoint(path).endswith("checkpoint-00000005.npz")
    assert ckpt.checkpoint_step(path) == 5
    assert ckpt.checkpoint_step(path, step=4) == 4
    np.testing.assert_array_equal(
        ckpt.load_checkpoint(path, tree, step=4)["w"], tree["w"] + 4)
    np.testing.assert_array_equal(ckpt.load_checkpoint(path, tree)["w"],
                                  tree["w"] + 5)
    with pytest.raises(ValueError, match="no step-2 checkpoint"):
        ckpt.load_checkpoint(path, tree, step=2)
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]


def test_keep_last_none_invalid_and_discard_after(tmp_path):
    path = str(tmp_path / "all")
    tree = {"w": np.zeros(2, np.float32)}
    for s in range(1, 5):
        ckpt.save_checkpoint(path, tree, step=s, keep_last=None)
    assert ckpt.checkpoint_steps(path) == [1, 2, 3, 4]
    with pytest.raises(ValueError, match="keep_last"):
        ckpt.save_checkpoint(path, tree, step=5, keep_last=0)
    ckpt.discard_after(path, 2)
    assert ckpt.checkpoint_steps(path) == [1, 2]
    ckpt.discard_after(path, 0)
    assert ckpt.checkpoint_steps(path) == []
    assert ckpt.latest_checkpoint(path) is None
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint bundle"):
        ckpt.load_checkpoint(path, tree)


def test_legacy_layouts(tmp_path):
    """The fixed-name bundle and the two-file layout still load; the first
    ring bundle supersedes a fixed-name one."""
    tree = {"w": np.arange(3, dtype=np.float32), "s": (None, np.ones(2))}
    flat = {k: np.asarray(v) for k, v in ckpt.flatten_with_path(tree)[0]}
    manifest = {"step": 9, "treedef": ckpt.flatten_with_path(tree)[1],
                "keys": list(flat)}
    two = tmp_path / "two"
    two.mkdir()
    np.savez(two / "arrays.npz", **flat)
    (two / "manifest.json").write_text(json.dumps(manifest))
    assert ckpt.latest_checkpoint(str(two)).endswith("arrays.npz")
    assert ckpt.checkpoint_step(str(two)) == 9
    _assert_same(ckpt.load_checkpoint(str(two), tree), tree)
    one = tmp_path / "one"
    one.mkdir()
    np.savez(one / "checkpoint.npz", **flat, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8))
    assert ckpt.latest_checkpoint(str(one)).endswith("checkpoint.npz")
    _assert_same(ckpt.load_checkpoint(str(one), tree), tree)
    _assert_same(ckpt.load_checkpoint(str(one / "checkpoint.npz"), tree),
                 tree)
    ckpt.save_checkpoint(str(one), tree, step=10)
    assert not (one / "checkpoint.npz").exists()
    assert ckpt.checkpoint_step(str(one)) == 10
    bare = tmp_path / "bare.npz"
    np.savez(bare, **flat)
    with pytest.raises(ValueError, match="has no manifest"):
        ckpt.checkpoint_step(str(bare))


@pytest.mark.parametrize("like,match", [
    ({"w": np.zeros(4, np.float32), "v": np.zeros(2)}, "shape mismatch for "
     "key \"\\['w'\\]\""),
    ({"w": np.zeros(3, np.float32), "u": np.zeros(2)}, "treedef mismatch"),
    ((np.zeros(3, np.float32), np.zeros(2)), "treedef mismatch"),
])
def test_load_errors(tmp_path, like, match):
    path = str(tmp_path / "err")
    ckpt.save_checkpoint(path, {"w": np.zeros(3, np.float32),
                                "v": np.zeros(2)}, step=1)
    with pytest.raises(ValueError, match=match):
        ckpt.load_checkpoint(path, like)


def test_load_error_missing_key(tmp_path):
    """Without a manifest nothing checks the structure, so a template key
    the bundle lacks is named."""
    bare = tmp_path / "bare.npz"
    np.savez(bare, **{"['w']": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="missing key \"\\['v'\\]\""):
        ckpt.load_checkpoint(str(bare), {"w": np.zeros(3, np.float32),
                                         "v": np.zeros(2)})


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

class _Preempt(Exception):
    pass


def _kill_after(monkeypatch, step_to_kill):
    """Preempt right after epoch ``step_to_kill``'s checkpoint lands."""
    orig = ckpt.save_checkpoint

    def killer(path, tree, step=0, **kw):
        orig(path, tree, step=step, **kw)
        if step == step_to_kill:
            raise _Preempt()

    monkeypatch.setattr(ckpt, "save_checkpoint", killer)


def _killed_and_resumed(monkeypatch, tmp_path, run, kill):
    ck = str(tmp_path / "ck")
    _kill_after(monkeypatch, kill)
    with pytest.raises(_Preempt):
        run(checkpoint_dir=ck)
    monkeypatch.undo()
    assert ckpt.checkpoint_steps(ck) == [kill]
    return run(resume_from=ck)


@pytest.mark.parametrize("engine", ["reference", "fused"])
@pytest.mark.parametrize("algo", ["sgd", "saga"])
def test_train_kill_and_resume_bit_exact(ds, layout, monkeypatch, tmp_path,
                                         engine, algo):
    x, y = ds
    prob = losses.logistic_l2(1e-3)

    def run(**kw):
        return algorithms.train(prob, x, y, layout, algo=algo, epochs=4,
                                lr=0.3, batch=BATCH, engine=engine,
                                device="cpu", **kw)

    full = run()
    res = _killed_and_resumed(monkeypatch, tmp_path, run, 2)
    assert np.array_equal(res.w, full.w)
    assert res.history == full.history


@pytest.mark.parametrize("engine", ["reference", "fused"])
def test_deep_train_kill_and_resume_bit_exact(ds, layout, monkeypatch,
                                              tmp_path, engine):
    x, y = ds
    prob = losses.logistic_l2(1e-3)

    def run(**kw):
        return algorithms.train(prob, x, y, layout, algo="svrg", epochs=3,
                                lr=0.1, batch=BATCH, deep=True, hidden=8,
                                d_rep=6, engine=engine, device="cpu", **kw)

    full = run()
    res = _killed_and_resumed(monkeypatch, tmp_path, run, 1)
    assert np.array_equal(res.w, full.w)
    for a, b in zip(res.params.enc_w1 + res.params.enc_w2,
                    full.params.enc_w1 + full.params.enc_w2):
        assert torch.equal(a, b)
    assert res.history == full.history


@pytest.mark.parametrize("engine", ["reference", "fused"])
def test_ring_bundle_equals_shorter_run(ds, layout, tmp_path, engine):
    """The supervisor's rollback guarantee: the step-2 bundle of a 4-epoch
    run is bit for bit the final bundle of a 2-epoch run with the same
    horizon — restoring it rewinds the trainer."""
    x, y = ds
    kw = dict(algo="saga", lr=0.3, batch=BATCH, seed=1, engine=engine,
              keep_last=4, horizon_epochs=4, device="cpu")
    prob = losses.logistic_l2(1e-3)
    a, b = str(tmp_path / "long"), str(tmp_path / "short")
    algorithms.train(prob, x, y, layout, epochs=4, checkpoint_dir=a, **kw)
    algorithms.train(prob, x, y, layout, epochs=2, checkpoint_dir=b, **kw)
    assert ckpt.checkpoint_steps(a) == [1, 2, 3, 4]
    da = np.load(os.path.join(a, "checkpoint-00000002.npz"))
    db = np.load(os.path.join(b, "checkpoint-00000002.npz"))
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def test_config_validation(jx):
    for kw in (dict(keep_last=1), dict(window=0), dict(spike_factor=1.0)):
        with pytest.raises(ValueError):
            SupervisorConfig(**kw)
        with pytest.raises(ValueError):
            jx.sup.SupervisorConfig(**kw)
    assert SupervisorConfig(keep_last=4).chunk \
        == jx.sup.SupervisorConfig(keep_last=4).chunk == 3


@pytest.mark.parametrize("objs,base0", [
    ([0.9, 0.8, np.nan, 0.7], None), ([0.9, 0.8, np.inf], None),
    ([1.0, 1.1, 0.9, 100.0], None), ([1.0, 1.1, 0.9, 0.8], None),
    ([5.0, 2.0, 1.0, 0.5], None), ([1e6, 1e6], None), ([1e6, 1e6], 0.7),
    ([1e6, 1e7], None), ([np.nan], 0.7), ([0.5, 3.0, 0.4], np.nan)])
@pytest.mark.parametrize("window,factor", [(3, 5.0), (1, 2.0)])
def test_first_divergence_matches_reference(jx, objs, base0, window,
                                            factor):
    kw = dict(window=window, spike_factor=factor)
    assert supervisor.first_divergence(
        objs, SupervisorConfig(**kw), base0=base0) \
        == jx.sup.first_divergence(objs, jx.sup.SupervisorConfig(**kw),
                                   base0=base0)


def test_poisoned_delay_correlated_realized_match_reference(jx, layout):
    rng = np.random.default_rng(3)
    finite = (rng.random((4, 12)) > 0.3).astype(np.float32)
    alive = (rng.random((4, 12)) > 0.3).astype(np.float32)
    h = faults.HealthStats(finite, alive, finite, alive)
    jh = jx.faults.HealthStats(finite, alive, finite, alive)
    np.testing.assert_array_equal(supervisor.poisoned_steps(h),
                                  jx.sup.poisoned_steps(jh))
    realized = [0.0, 0.0, 2.0, 0.0, 1.0]
    for div, total in (([2], 5), ([1], 5), ([], 5), ([0, 1, 2, 3, 4], 5),
                       ([2, 4], 3), ([4], 5)):
        assert supervisor.delay_correlated(realized, div, total) \
            == jx.sup.delay_correlated(realized, div, total)
    ev = (faults.FaultEvent(STEPS + 2, 1, "straggle", k=5),
          faults.FaultEvent(2 * STEPS, 3, "straggle", k=1))
    tr = faults.FaultTrace(q=layout.q, steps=3 * STEPS, events=ev)
    jtr = jx.faults.FaultTrace(q=layout.q, steps=3 * STEPS, events=tuple(
        jx.faults.FaultEvent(e.step, e.party, e.kind, k=e.k) for e in ev))
    base = np.asarray([1, 0, 0, 2])
    got = supervisor.realized_epoch_delays(tr.compile(), base, STEPS, 3, TAU)
    np.testing.assert_array_equal(got, jx.sup.realized_epoch_delays(
        jtr.compile(), base, STEPS, 3, TAU))
    np.testing.assert_array_equal(got, [2.0, 2.0, 2.0])


def test_supervised_train_heals_lr_spike(ds, layout, tmp_path):
    """Ridge at a divergent learning rate: unsupervised it blows up;
    supervised it rolls back, backs the rate off and converges."""
    x, y = ds
    prob = losses.ridge(1e-3)
    kw = dict(algo="sgd", epochs=6, lr=50.0, batch=BATCH, seed=1,
              engine="fused", device="cpu")
    bad = algorithms.train(prob, x, y, layout, **kw)
    assert not np.isfinite([h["objective"] for h in bad.history]).all()
    res = algorithms.train(prob, x, y, layout, supervise=True,
                           supervisor_config=SupervisorConfig(
                               lr_backoff=0.1, max_retries=4),
                           checkpoint_dir=str(tmp_path / "sup"), **kw)
    assert res.heals
    assert all(h["reason"] in ("nonfinite", "spike") for h in res.heals)
    assert all(h["lr"] < 50.0 for h in res.heals)
    objs = [h["objective"] for h in res.history]
    assert len(objs) == 6 and np.isfinite(objs).all()
    assert objs[-1] < objs[0]


@pytest.mark.parametrize("deep", [False, True], ids=["linear", "deep"])
def test_supervised_train_clean_run_untouched(ds, layout, tmp_path, deep):
    """A healthy run under supervision is bit for bit the unsupervised
    one: segmenting against the ring does not change the math."""
    x, y = ds
    prob = losses.logistic_l2(1e-3)
    kw = dict(algo="sgd", epochs=4, lr=0.1 if deep else 0.3, batch=BATCH,
              seed=1, engine="fused", deep=deep, hidden=8, d_rep=6,
              device="cpu")
    plain = algorithms.train(prob, x, y, layout, **kw)
    sup = algorithms.train(prob, x, y, layout, supervise=True,
                           checkpoint_dir=str(tmp_path / "clean"), **kw)
    assert sup.heals == []
    assert np.array_equal(sup.w, plain.w)
    assert sup.history == plain.history


def test_divergence_error_on_exhausted_budget(ds, layout, tmp_path):
    x, y = ds
    cfg = SupervisorConfig(max_retries=2, lr_backoff=1.0, keep_last=2)
    with pytest.raises(DivergenceError, match="after 2 rollbacks"):
        algorithms.train(losses.ridge(1e-3), x, y, layout, algo="sgd",
                         epochs=6, lr=50.0, batch=BATCH, seed=1,
                         engine="fused", supervise=True,
                         supervisor_config=cfg, device="cpu",
                         checkpoint_dir=str(tmp_path / "exhaust"))


def test_guard_escalation_after_poisoning(ds, layout, tmp_path):
    """guard=False and a NaN partial poison the aggregate; the supervisor
    reads it off the health stream, turns the guard on for the retry
    (unguarded, the retry would re-poison) and completes."""
    x, y = ds
    epochs = 4
    ev = (faults.FaultEvent(2 * STEPS + 1, 1, "corrupt", mode="nan"),)
    tr = faults.FaultTrace(q=layout.q, steps=epochs * STEPS, events=ev)
    w, health, heals = supervised_guarded_run(
        losses.logistic_l2(1e-3), x, y, layout, tr, TAU, epochs, 0.3, BATCH,
        algo="sgd", seed=1, guard=False, device="cpu",
        checkpoint_dir=str(tmp_path / "esc"),
        config=SupervisorConfig(keep_last=2))
    assert [(h["reason"], h["diverged_epoch"], h["rollback_step"],
             h["guard"]) for h in heals] == [("poisoned", 3, 2, True)]
    assert np.isfinite(w).all()
    assert not supervisor.poisoned_steps(health).any()
    assert health.finite[1, 2 * STEPS + 1] == 0


def test_adaptive_tau_tightens_on_delay_correlated_spike(ds, layout,
                                                         tmp_path):
    """A blowup spike beside a straggler: the diverged epoch's realized
    delay exceeds the healthy mean, so τ tightens with the backoff."""
    x, y = ds
    epochs = 5
    ev = (faults.FaultEvent(2 * STEPS + 1, 1, "corrupt", mode="blowup"),
          faults.FaultEvent(2 * STEPS + 1, 1, "straggle", k=2))
    tr = faults.FaultTrace(q=layout.q, steps=epochs * STEPS, events=ev)
    cfg = SupervisorConfig(window=3, spike_factor=3.0, max_retries=5,
                           lr_backoff=0.1, keep_last=2)
    w, health, heals = supervised_guarded_run(
        losses.ridge(1e-3), x, y, layout, tr, TAU, epochs, 0.05, BATCH,
        algo="sgd", seed=1, guard=True, delays_q=np.zeros(layout.q, int),
        checkpoint_dir=str(tmp_path / "tau"), config=cfg, device="cpu")
    assert heals and heals[0]["reason"] == "spike"
    assert heals[0]["tau_eff"] == TAU - 1
    assert heals[0]["lr"] == pytest.approx(0.005)
    assert np.isfinite(w).all()
    assert health.finite.min() == 1     # a blowup is finite: norms only


def test_supervised_guarded_run_options(ds, layout, tmp_path):
    x, y = ds
    tr = faults.FaultTrace(q=layout.q, steps=2 * STEPS)
    kw = dict(device="cpu")
    # deep=True runs the deep guarded epochs under supervision
    p, health, heals = supervised_guarded_run(
        losses.ridge(), x, y, layout, tr, TAU, 2, 0.1, BATCH, deep=True,
        hidden=4, d_rep=3, checkpoint_dir=str(tmp_path), **kw)
    assert all(np.isfinite(np.asarray(a)).all()
               for a in (*p.enc_w1, *p.enc_b1, *p.enc_w2, p.head))
    assert health.finite.shape == (layout.q, 2 * STEPS) and not heals
    with pytest.raises(ValueError, match="checkpoint_dir"):
        supervised_guarded_run(losses.ridge(), x, y, layout, tr, TAU, 2,
                               0.1, BATCH, **kw)
