"""The port's deep VFB² training against the JAX package.

Deep VFB²: each party holds a private two-layer encoder, the (B, d_rep)
partials go through Algorithm 1, and ϑ_z = ϑ_logit·head is broadcast back
for each party's Jacobian-transpose update.

* ``pack_deep`` / ``unpack_deep`` give the reference's padded stack bit
  for bit;
* the sequential oracle ``deep_vfl.train_deep_vfl`` against the JAX
  oracle, SGD and SVRG in the four forms (fresh, multi-dominator,
  pipelined, both), handed the JAX key stream's schedules (``indices=``),
  at 1e-5 on every leaf and objective; ``train_centralized`` against the
  JAX one; the BUM trajectory against the port's own centralized
  autodiff, at the reference's tolerance (``tests/test_deep_vfl.py``);
* the engine's 8 deep epochs against the JAX ``FusedEngine``'s over two
  chained epochs on the reference's ``_batch_indices`` schedules, and
  ``deep_full_gradient`` / ``deep_objective``, at 1e-5; each epoch also
  against the port's oracle at 1e-5;
* ``two_tree`` and ``ring`` within 1e-5 of ``off``; ``active_only``
  freezes the passive encoders; the pipelined trajectory differs from the
  sequential one;
* a fresh SGD step makes 4 ``ops.vfl_grad`` calls, an SVRG step 6, a
  pipelined interior step exactly one, fused with ``split``;
* ``train(deep=True)``: the fused engine against the oracle, a
  ``deep_params=`` warm start, SAGA and a flat ``w0`` rejected;
* the ``cuda``-marked test runs the 8 kinds on the card under
  ``torch.cuda.set_sync_debug_mode("error")`` against the CPU engine.

Sizes are the reference's deep files': N = 600, D = 32, hidden 16, d_rep
8, batch 32, 2 epochs, q = 4 with m = 2 and, for the single-dominator
kinds, q = 2 with m = 1.  JAX runs inside module-scoped fixtures, once
per (layout, kind, algo), with ``secure="off"``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, deep_vfl, engine, losses
from repro_torch.data import classification_dataset
from repro_torch.kernels import ops

N, D, BATCH, EPOCHS, HID, DREP, LR = 600, 32, 32, 2, 16, 8, 0.05
LAYOUTS = {"q4m2": (4, 2), "q2m1": (2, 1)}
# kind -> (multi-dominator, pipelined)
KINDS = {"fresh": (False, False), "multi": (True, False),
         "pipelined": (False, True), "multi_pipelined": (True, True)}
CASES = [("q4m2", kind, algo) for kind in KINDS for algo in ("sgd", "svrg")] \
    + [("q2m1", kind, algo) for kind in ("fresh", "pipelined")
       for algo in ("sgd", "svrg")]
IDS = ["-".join(c) for c in CASES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small, and
    the suite runs several test processes on one machine's cores, where
    more threads a process only contend.  The count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return classification_dataset("deep_sched", N, D, seed=5, noise=0.4)


@pytest.fixture(scope="module")
def prob():
    return losses.logistic_l2()


def _layout(lid):
    return algorithms.PartyLayout.even(D, *LAYOUTS[lid])


def _method(kind, algo):
    multi, pipelined = KINDS[kind]
    return "deep_" + ("multi_" if multi else "") \
        + ("pipelined_" if pipelined else "") + f"{algo}_epoch"


def _rows(lid, kind):
    return (LAYOUTS[lid][1] if KINDS[kind][0] else 1) * BATCH


def _leaves(p):
    return [np.asarray(a) for a in
            (*p.enc_w1, *p.enc_b1, *p.enc_w2, p.head)]


def _close_params(got, want, atol=1e-5):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _drive(te, kind, algo, pq, idxs, key0=0):
    """The port engine's ``kind``/``algo`` epochs from ``pq`` over the
    schedules ``idxs`` (SVRG: the snapshot aliases the iterate, μ from
    ``deep_full_gradient``)."""
    fn = getattr(te, _method(kind, algo))
    for ep, idx in enumerate(idxs):
        key = (key0, ep)
        if algo == "sgd":
            pq = fn(pq, LR, idx, key)
        else:
            pq = fn(pq, pq, te.deep_full_gradient(pq, key), LR, idx, key)
    return pq


@pytest.fixture(scope="module")
def jx(ds):
    """The JAX package's runs, each made once per (layout, kind, algo):
    its init, schedules, oracle and engine epochs (``secure="off"``)."""
    import jax
    from repro.core import algorithms as jalg
    from repro.core import deep_vfl as jdeep
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    prob = jloss.logistic_l2()
    n = ds.y_train.shape[0]
    cache = {}

    def start(lid):
        """The reference's init from PRNGKey(0) (as both its trainers
        draw it) and its per-epoch schedules for each row count."""
        if ("start", lid) not in cache:
            layout = jalg.PartyLayout.even(D, *LAYOUTS[lid])
            p0 = jdeep.init_deep_vfl(jax.random.PRNGKey(0), layout, D, HID,
                                     DREP)
            idxs = {}
            for rows in {BATCH, LAYOUTS[lid][1] * BATCH}:
                key, out = jax.random.PRNGKey(0), []
                for _ in range(EPOCHS):
                    key, sub = jax.random.split(key)
                    out.append(np.array(jalg._batch_indices(
                        sub, n, rows, n // BATCH)))
                idxs[rows] = out
            cache["start", lid] = (layout, p0, idxs)
        return cache["start", lid]

    def engine_of(lid):
        if ("engine", lid) not in cache:
            layout = start(lid)[0]
            cache["engine", lid] = jeng.FusedEngine(
                prob, ds.x_train, ds.y_train, layout,
                jeng.EngineConfig(secure="off"))
        return cache["engine", lid]

    def oracle(lid, kind, algo):
        if ("oracle", lid, kind, algo) not in cache:
            layout = start(lid)[0]
            multi, pipelined = KINDS[kind]
            cache["oracle", lid, kind, algo] = jdeep.train_deep_vfl(
                prob, ds.x_train, ds.y_train, layout, epochs=EPOCHS, lr=LR,
                batch=BATCH, seed=0, hidden=HID, d_rep=DREP, algo=algo,
                multi_dominator=multi, pipelined=pipelined)
        return cache["oracle", lid, kind, algo]

    def epochs(lid, kind, algo):
        """The JAX engine's two chained epochs and the final objective."""
        if ("epochs", lid, kind, algo) not in cache:
            eng = engine_of(lid)
            p0 = start(lid)[1]
            fn = getattr(eng, _method(kind, algo))
            pq, key = eng.pack_deep(p0), jax.random.PRNGKey(0)
            for _ in range(EPOCHS):
                key, sub = jax.random.split(key)
                if algo == "sgd":
                    pq = fn(pq, LR, sub, BATCH, n // BATCH)
                else:
                    mu = eng.deep_full_gradient(pq, sub)
                    pq = fn(pq, pq, mu, LR, sub, BATCH, n // BATCH)
            cache["epochs", lid, kind, algo] = (eng.unpack_deep(pq),
                                                eng.deep_objective(pq))
        return cache["epochs", lid, kind, algo]

    def centralized():
        if "centralized" not in cache:
            cache["centralized"] = jdeep.train_centralized(
                prob, ds.x_train, ds.y_train, start("q4m2")[0],
                epochs=EPOCHS, lr=LR, batch=BATCH, seed=0, hidden=HID,
                d_rep=DREP)
        return cache["centralized"]

    return types.SimpleNamespace(jax=jax, start=start, engine=engine_of,
                                 oracle=oracle, epochs=epochs,
                                 centralized=centralized)


@pytest.fixture(scope="module")
def port(ds, prob, jx):
    """The port's engines (per layout and secure mode) and its oracle runs
    from the reference's init on the reference's schedules, each made
    once."""
    cache = {}

    def engine_of(lid, secure="off", active_only=False):
        k = ("engine", lid, secure, active_only)
        if k not in cache:
            cache[k] = engine.FusedEngine(
                prob, ds.x_train, ds.y_train, _layout(lid),
                engine.EngineConfig(secure=secure), active_only=active_only,
                device="cpu")
        return cache[k]

    def start(lid, kind="fresh"):
        _, p0, idxs = jx.start(lid)
        return (convert.deep_params(p0, device="cpu"),
                [torch.from_numpy(i) for i in idxs[_rows(lid, kind)]])

    def oracle(lid, kind, algo, **kw):
        k = ("oracle", lid, kind, algo, tuple(sorted(kw.items())))
        if k not in cache:
            multi, pipelined = KINDS[kind]
            p0, idxs = start(lid, kind)
            cache[k] = deep_vfl.train_deep_vfl(
                prob, ds.x_train, ds.y_train, _layout(lid), epochs=EPOCHS,
                lr=LR, batch=BATCH, params=p0, algo=algo,
                multi_dominator=multi, pipelined=pipelined, indices=idxs,
                device="cpu", **kw)
        return cache[k]

    def epochs(lid, kind, algo, secure="off", active_only=False):
        k = ("epochs", lid, kind, algo, secure, active_only)
        if k not in cache:
            te = engine_of(lid, secure, active_only)
            p0, idxs = start(lid, kind)
            cache[k] = _drive(te, kind, algo, te.pack_deep(p0), idxs)
        return cache[k]

    return types.SimpleNamespace(engine=engine_of, start=start,
                                 oracle=oracle, epochs=epochs)


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lid", list(LAYOUTS))
def test_pack_deep_matches_reference(jx, port, lid):
    _, p0, _ = jx.start(lid)
    te = port.engine(lid)
    got = te.pack_deep(convert.deep_params(p0, device="cpu"))
    want = jx.engine(lid).pack_deep(p0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = te.unpack_deep(got)
    for g, w in zip(_leaves(back), _leaves(p0)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the sequential oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lid,kind,algo", CASES, ids=IDS)
def test_oracle_matches_jax(jx, port, lid, kind, algo):
    want, want_hist = jx.oracle(lid, kind, algo)
    got, hist = port.oracle(lid, kind, algo)
    _close_params(got, want)
    np.testing.assert_allclose(hist, want_hist, atol=1e-5, rtol=0)


def test_centralized_matches_jax(ds, prob, jx, port):
    want, want_hist = jx.centralized()
    p0, idxs = port.start("q4m2")
    got, hist = deep_vfl.train_centralized(
        prob, ds.x_train, ds.y_train, _layout("q4m2"), epochs=EPOCHS, lr=LR,
        batch=BATCH, params=p0, indices=idxs, device="cpu")
    _close_params(got, want)
    np.testing.assert_allclose(hist, want_hist, atol=1e-5, rtol=0)


def test_bum_equals_centralized_autodiff(ds, prob):
    """The protocol's gradients (ϑ broadcast, each party's own Jacobian)
    give the trajectory of one centralized autograd graph, at the
    reference's tolerance (``tests/test_deep_vfl.py``)."""
    layout = _layout("q4m2")
    kw = dict(epochs=EPOCHS, lr=LR, batch=BATCH, seed=3, hidden=HID,
              d_rep=DREP, device="cpu")
    p1, h1 = deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train, layout,
                                     **kw)
    p2, h2 = deep_vfl.train_centralized(prob, ds.x_train, ds.y_train,
                                        layout, **kw)
    np.testing.assert_allclose(h1, h2, atol=1e-4)
    _close_params(p1, p2, atol=1e-4)


def test_oracle_options(ds, prob, tmp_path):
    layout = _layout("q4m2")
    with pytest.raises(FileNotFoundError, match="no checkpoint bundle"):
        deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train, layout,
                                resume_from=str(tmp_path / "ckpt"),
                                device="cpu")
    with pytest.raises(ValueError, match="saga"):
        deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train, layout,
                                algo="saga", device="cpu")
    with pytest.raises(ValueError, match="schedules"):
        deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train, layout,
                                epochs=2, indices=[np.zeros((3, BATCH))],
                                device="cpu")


# ---------------------------------------------------------------------------
# the engine's deep epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lid,kind,algo", CASES, ids=IDS)
def test_engine_epochs_match_jax_engine(jx, port, lid, kind, algo):
    want, want_obj = jx.epochs(lid, kind, algo)
    te = port.engine(lid)
    pq = port.epochs(lid, kind, algo)
    _close_params(te.unpack_deep(pq), want)
    assert abs(te.deep_objective(pq) - want_obj) <= 1e-5


@pytest.mark.parametrize("lid,kind,algo", CASES[:8], ids=IDS[:8])
def test_engine_epochs_match_port_oracle(port, lid, kind, algo):
    te = port.engine(lid)
    pq = port.epochs(lid, kind, algo)
    want, hist = port.oracle(lid, kind, algo)
    _close_params(te.unpack_deep(pq), want)
    assert abs(te.deep_objective(pq) - hist[-1]) <= 1e-5


@pytest.mark.parametrize("lid", list(LAYOUTS))
def test_full_gradient_and_objective_match_jax(jx, port, lid):
    je, te = jx.engine(lid), port.engine(lid)
    _, p0, _ = jx.start(lid)
    jpq = je.pack_deep(p0)
    pq = te.pack_deep(convert.deep_params(p0, device="cpu"))
    want = je.deep_full_gradient(jpq, jx.jax.random.PRNGKey(1))
    for g, w in zip(te.deep_full_gradient(pq, (1,)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    assert abs(te.deep_objective(pq) - je.deep_objective(jpq)) <= 1e-5


@pytest.mark.parametrize("secure", ["two_tree", "ring"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_secure_modes_are_lossless(port, kind, secure):
    """Algorithm 1's masks on the (m·B, d_rep) vector partials cancel:
    every leaf within 1e-5 of the ``off`` run (SVRG's two partial sets
    ride one masked aggregation)."""
    te = port.engine("q4m2")
    for algo in ("sgd", "svrg"):
        got = port.epochs("q4m2", kind, algo, secure)
        _close_params(te.unpack_deep(got),
                      te.unpack_deep(port.epochs("q4m2", kind, algo)))


@pytest.mark.parametrize("kind", ["fresh", "multi"])
def test_active_only_freezes_passive_encoders(port, kind):
    """``active_only`` (the engine's ``trainq`` and update mask) matches
    the oracle's ``freeze_passive``: the passive encoders stay at their
    start while the active ones and the head train."""
    te = port.engine("q4m2", active_only=True)
    got = te.unpack_deep(port.epochs("q4m2", kind, "sgd",
                                     active_only=True))
    want, _ = port.oracle("q4m2", kind, "sgd", freeze_passive=True)
    _close_params(got, want)
    p0, _ = port.start("q4m2")
    m = LAYOUTS["q4m2"][1]
    for leaf in ("enc_w1", "enc_b1", "enc_w2"):
        for p in range(m, LAYOUTS["q4m2"][0]):
            np.testing.assert_array_equal(getattr(got, leaf)[p].numpy(),
                                          getattr(p0, leaf)[p].numpy())
        assert float((getattr(got, leaf)[0]
                      - getattr(p0, leaf)[0]).abs().max()) > 1e-6
    assert float((got.head - p0.head).abs().max()) > 1e-6


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_pipelined_differs_from_sequential(port, multi):
    """The τ = 1 stale read changes the trajectory, on the engine and on
    the oracle."""
    te = port.engine("q4m2")
    pipe, seq = ("multi_pipelined", "multi") if multi \
        else ("pipelined", "fresh")
    for run in (lambda k: te.unpack_deep(port.epochs("q4m2", k, "sgd")),
                lambda k: port.oracle("q4m2", k, "sgd")[0]):
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(_leaves(run(pipe)), _leaves(run(seq))))
        assert diff > 1e-6, diff


# ---------------------------------------------------------------------------
# launches: the contractions each step makes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,algo", [(k, a) for k in KINDS
                                       for a in ("sgd", "svrg")])
def test_step_contractions(port, monkeypatch, kind, algo):
    """A fresh SGD step calls ``ops.vfl_grad`` 4 times (layer 1 and layer
    2 forward, hᵀϑ_z and xᵀ∂u), an SVRG step 6 (the iterate and the
    snapshot share layer 1's forward and backward); a pipelined interior
    step exactly once, fused with ``split``, beside a forward prologue
    and a backward epilogue (steps + 1 calls an epoch)."""
    te = port.engine("q4m2")
    p0, idxs = port.start("q4m2", kind)
    idx = idxs[0]
    steps, rows = idx.shape[0], idx.shape[1]
    pq = te.pack_deep(p0)
    mu = te.deep_full_gradient(pq) if algo == "svrg" else None
    pipelined = KINDS[kind][1]
    step_name = "_deep_pipe_step" if pipelined else "_deep_fresh_step"
    calls, per_step = [], []
    real_call, real_step = ops.vfl_grad, getattr(te, step_name)

    def counting_call(*args, **kw):
        calls.append((kw.get("mode", "forward"), kw.get("split")))
        return real_call(*args, **kw)

    def counting_step(*args):
        n0 = len(calls)
        real_step(*args)
        per_step.append(calls[n0:])

    monkeypatch.setattr(ops, "vfl_grad", counting_call)
    monkeypatch.setattr(te, step_name, counting_step)
    fn = getattr(te, _method(kind, algo))
    if algo == "sgd":
        fn(pq, LR, idx)
    else:
        fn(pq, pq, mu, LR, idx)
    if pipelined:
        assert per_step == [[("fused", rows)]] * (steps - 1)
        assert calls == [("forward", None)] + [("fused", rows)] \
            * (steps - 1) + [("backward", None)]
    else:
        fwd, bwd = (3, 3) if algo == "svrg" else (2, 2)
        assert per_step == [[("forward", None)] * fwd
                            + [("backward", None)] * bwd] * steps


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("algo", ["sgd", "svrg"])
def test_train_deep_fused_matches_reference(ds, prob, kind, algo):
    multi, pipelined = KINDS[kind]
    kw = dict(algo=algo, epochs=EPOCHS, lr=LR, batch=BATCH, seed=7,
              deep=True, hidden=HID, d_rep=DREP, multi_dominator=multi,
              pipelined=pipelined, device="cpu")
    layout = _layout("q4m2")
    ref = algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    fused = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                             engine="fused", **kw)
    _close_params(fused.params, ref.params)
    np.testing.assert_array_equal(fused.w, fused.params.head.numpy())
    np.testing.assert_array_equal(ref.w, ref.params.head.numpy())
    assert len(fused.history) == len(ref.history) == EPOCHS
    for hf, hr in zip(fused.history, ref.history):
        assert hf["algo"] == hr["algo"] == f"deep_{algo}"
        assert abs(hf["objective"] - hr["objective"]) <= 1e-5


def test_train_deep_warm_start(ds, prob, port):
    """``deep_params=`` starts either engine from the given parameters:
    the fused trainer equals the oracle from the same start on the
    trainer's schedule, and not the default start's run."""
    p0, _ = port.start("q4m2")
    layout = _layout("q4m2")
    kw = dict(algo="sgd", epochs=1, lr=LR, batch=BATCH, seed=2,
              device="cpu")
    got = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                           engine="fused", deep=True, deep_params=p0,
                           hidden=HID, d_rep=DREP, **kw)
    want, _ = deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train, layout,
                                      params=p0, **kw)
    _close_params(got.params, want)
    cold = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                            engine="fused", deep=True, hidden=HID,
                            d_rep=DREP, **kw)
    assert float(np.abs(cold.w - got.w).max()) > 1e-3


def test_train_deep_rejects_saga_and_flat_w0(ds, prob):
    layout = _layout("q4m2")
    for engine_name in ("reference", "fused"):
        with pytest.raises(ValueError, match="sgd"):
            algorithms.train(prob, ds.x_train, ds.y_train, layout,
                             algo="saga", deep=True, engine=engine_name,
                             device="cpu")
        with pytest.raises(ValueError, match="w0"):
            algorithms.train(prob, ds.x_train, ds.y_train, layout,
                             deep=True, w0=np.zeros(D), engine=engine_name,
                             device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_cuda_deep_epochs_match_cpu_without_a_sync(cuda_device, ds, prob,
                                                   kind):
    """On the card each deep epoch is an eager step (pipelined: prologue
    and epilogue) and replays of one captured step: SGD then SVRG run
    under ``set_sync_debug_mode("error")``, a captured fresh step
    launches the wide forward twice and the rows backward twice (SVRG 3
    and 3), a pipelined one ``vfl_fused_split`` once; the epochs replay
    bit for bit and equal the CPU engine within 1e-5."""
    from repro_torch.kernels import vfl_grad as vg
    layout = _layout("q4m2")
    cfg = engine.EngineConfig(secure="two_tree")
    ec = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device="cpu")
    eg = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device=cuda_device)
    rows = _rows("q4m2", kind)
    idxs = [algorithms.epoch_indices(0, ep, ec.n, rows, ec.n // BATCH)
            for ep in range(EPOCHS)]
    idgs = [i.to(cuda_device) for i in idxs]
    p0 = deep_vfl.initial_params(0, layout, D, HID, DREP)
    pq0, pqg = ec.pack_deep(p0), eg.pack_deep(p0)

    def run(eng, pq, ix):
        out = _drive(eng, kind, "sgd", pq, ix)
        return out + _drive(eng, kind, "svrg", out, ix, key0=1)

    for _ in range(2):                    # capture, then reuse the graphs
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(eg, pqg, idgs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    loops = list(eg._loops.values())      # this kind's SGD and SVRG
    assert len(loops) == 2
    for lp in loops:
        n = 3 if "w1s" in lp.bufs else 2  # SVRG carries the snapshot
        assert lp.per_step == ({"vfl_fused_split": 1} if KINDS[kind][1]
                               else {"vfl_forward_wide": n,
                                     "vfl_backward_rows": n})
    again = run(eg, pqg, idgs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, c in zip(got, run(ec, pq0, idxs)):
        torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=0)
