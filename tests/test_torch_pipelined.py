"""The port's pipelined and multi-dominator pipelined epochs against the
JAX package.

The pipelined epochs run the τ = 1 schedule: round t's BUM application
uses the forward read taken before round t−1's update, so backward(t) and
forward(t+1) share one split-batch ``vfl_grad(mode="fused")`` call.

* ``{,multi_}pipelined_{sgd,svrg,saga}_epoch`` against the JAX
  ``FusedEngine``'s on the same data and the same schedule (the
  reference's own ``_batch_indices``): at 1e-6 with ``secure="off"`` and
  at 1e-5 with masks;
* each against the port's own oracle at 1e-6;
* the pipelined trajectory differs from the sequential one, while a
  1-step epoch equals it at 1e-7;
* every interior step makes exactly one ``ops.vfl_grad`` call, in
  ``mode="fused"`` with ``split``;
* ``train(pipelined=True[, multi_dominator=True], engine="fused")``
  against ``engine="reference"`` over 3 epochs at 1e-5;
* the ``cuda``-marked test runs the 6 epochs on the card under
  ``torch.cuda.set_sync_debug_mode("error")`` against the CPU engine, and
  checks that each captured interior step launches ``vfl_fused_split``
  once and no other program.

Sizes are those of ``tests/test_torch_train.py``: the D = 50 logistic set
over q = 8 parties with m = 3 (uneven widths), batch 32, 25 steps.  JAX is
imported inside fixtures.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, engine, losses
from repro_torch.data import classification_dataset
from repro_torch.kernels import ops

D, Q, M, BATCH, STEPS, LR = 50, 8, 3, 32, 25, 0.5
SECURE = ("off", "two_tree", "ring")
ATOL = {"off": 1e-6, "two_tree": 1e-5, "ring": 1e-5}
KINDS = {"pipelined": 1, "multi_pipelined": M}   # kind -> dominators/step


@pytest.fixture(scope="module")
def ds():
    return classification_dataset("eng", 1000, D, seed=3, noise=0.4)


@pytest.fixture(scope="module")
def layout():
    return algorithms.PartyLayout.even(D, Q, M)


@pytest.fixture(scope="module")
def prob():
    return losses.logistic_l2()


@pytest.fixture(scope="module")
def jx():
    import jax
    from repro.core import algorithms as jalg
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    return types.SimpleNamespace(jax=jax, alg=jalg, eng=jeng,
                                 prob=jloss.logistic_l2(),
                                 layout=jalg.PartyLayout.even(D, Q, M))


@pytest.fixture(scope="module")
def engines(ds, layout, prob, jx):
    """(JAX engine, port engine) per secure mode, built once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = (
                jx.eng.FusedEngine(jx.prob, ds.x_train, ds.y_train,
                                   jx.layout,
                                   jx.eng.EngineConfig(secure=mode)),
                engine.FusedEngine(prob, ds.x_train, ds.y_train, layout,
                                   engine.EngineConfig(secure=mode),
                                   device="cpu"))
        return cache[mode]

    return get


def _start(jx, je, seed, kind):
    """A JAX key, the schedule the JAX epochs of ``kind`` draw from it,
    and a nonzero starting iterate on both sides."""
    key = jx.jax.random.PRNGKey(seed)
    idx = np.array(jx.alg._batch_indices(key, je.n, KINDS[kind] * BATCH,
                                         STEPS))
    w0 = 0.1 * np.random.default_rng(seed).standard_normal(D)
    jwq = je.pack_w(w0.astype(np.float32))
    return key, idx, jwq, convert.linear_iterate(np.asarray(jwq),
                                                 device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _port_epoch(te, kind, algo, wq, idx, key=(0,), state=None):
    """Run the port's ``{kind}_{algo}_epoch`` from ``wq``; ``state`` is the
    SVRG (snapshot, mu) or SAGA (table, average) it starts from (made
    from ``wq`` when None).  Returns a tuple of outputs."""
    fn = getattr(te, f"{kind}_{algo}_epoch")
    if algo == "sgd":
        return (fn(wq, LR, idx, key),)
    if algo == "svrg":
        snap, mu = state or (wq, te.full_gradient(wq))
        return (fn(wq, snap, mu, LR, idx, key),)
    tab, avg = state or te.saga_init(wq)
    return fn(wq, tab, avg, LR, idx, key)


@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_pipelined_epoch_matches_jax(engines, jx, kind, algo, mode):
    je, te = engines(mode)
    key, idx, jwq, twq = _start(jx, je, 50, kind)
    fn = getattr(je, f"{kind}_{algo}_epoch")
    if algo == "sgd":
        want, state = (fn(jwq, LR, key, BATCH, STEPS),), None
    elif algo == "svrg":
        jmu = je.full_gradient(jwq, key)
        want = (fn(jwq, jwq, jmu, LR, key, BATCH, STEPS),)
        state = convert.svrg_state(np.asarray(jwq), np.asarray(jmu),
                                   device="cpu")
    else:
        jtab, javg = je.saga_init(jwq, key)
        want = fn(jwq, jtab, javg, LR, key, BATCH, STEPS)
        state = convert.saga_state(np.asarray(jtab), np.asarray(javg),
                                   device="cpu")
    got = _port_epoch(te, kind, algo, twq, idx, (50,), state)
    for g, w in zip(got, want):
        _close(g, w, ATOL[mode])


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_pipelined_epochs_match_port_oracle(ds, layout, prob, engines, jx,
                                            kind, algo):
    """The engine's party-stacked epoch equals the oracle's pooled one."""
    _, te = engines("off")
    _, idx, _, twq = _start(jx, engines("off")[0], 51, kind)
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    w = torch.from_numpy(te.unpack_w(twq))
    mask = torch.from_numpy(layout.update_mask(D, False))
    idx = torch.from_numpy(idx)
    oracle = getattr(algorithms, f"{kind}_{algo}_epoch")
    extra = (M,) if kind == "multi_pipelined" else ()
    got = _port_epoch(te, kind, algo, twq, idx)
    if algo == "sgd":
        want = (oracle(prob, w, x, y, LR, mask, idx, *extra),)
    elif algo == "svrg":
        mu = algorithms.full_gradient(prob, w, x, y)
        want = (oracle(prob, w, w, mu, x, y, LR, mask, idx, *extra),)
    else:
        tab, avg = algorithms.saga_init(prob, w, x, y)
        want = oracle(prob, w, tab, avg, x, y, LR, mask, idx, *extra)
        _close(got[1], want[1].expand(Q, -1), 1e-6)
        _close(te.unpack_w(got[2]), want[2], 1e-6)
    _close(te.unpack_w(got[0]), want[0], 1e-6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_pipelined_schedule_is_genuinely_stale(ds, layout, prob, engines,
                                               kind):
    """The pipelined trajectory differs from the sequential one (ϑ reads
    are one update old), while a 1-step epoch (prologue and epilogue, no
    interior step) equals the sequential step exactly — on the engine and
    on the oracles."""
    te = engines("off")[1]
    rows = KINDS[kind] * BATCH
    seq = {"pipelined": "sgd_epoch",
           "multi_pipelined": "multi_sgd_epoch"}[kind]
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    mask = torch.from_numpy(layout.update_mask(D, False))
    extra = (M,) if kind == "multi_pipelined" else ()
    w0 = torch.zeros(D)
    for steps, same in ((STEPS, False), (1, True)):
        idx = algorithms.epoch_indices(52, 0, te.n, rows, steps)
        pipe_e = te.unpack_w(getattr(te, f"{kind}_sgd_epoch")(
            te.pack_w(w0), LR, idx))
        seq_e = te.unpack_w(getattr(te, seq)(te.pack_w(w0), LR, idx))
        pipe_o = getattr(algorithms, f"{kind}_sgd_epoch")(
            prob, w0, x, y, LR, mask, idx, *extra)
        seq_o = getattr(algorithms, seq)(prob, w0, x, y, LR, mask, idx,
                                         *extra)
        for pipe, sq in ((pipe_e, seq_e), (pipe_o.numpy(), seq_o.numpy())):
            if same:
                _close(pipe, sq, 1e-7)
            else:
                assert float(np.abs(pipe - sq).max()) > 1e-4


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_interior_step_is_one_fused_call(engines, monkeypatch, kind, algo):
    """Every interior step calls ``ops.vfl_grad`` exactly once, in the
    fused mode with ``split`` (the port's form of the reference's audit
    of one ``pallas_call`` per scan body); the prologue is one forward
    call and the epilogue one backward call."""
    te = engines("off")[1]
    idx = algorithms.epoch_indices(53, 0, te.n, KINDS[kind] * BATCH, STEPS)
    wq = te.pack_w(0.1 * np.random.default_rng(53).standard_normal(D))
    state = None if algo == "sgd" else (
        (wq, te.full_gradient(wq)) if algo == "svrg" else te.saga_init(wq))
    calls, per_step = [], []
    real_call, real_step = ops.vfl_grad, te._pipe_step

    def counting_call(*args, **kw):
        calls.append((kw.get("mode", "forward"), kw.get("split")))
        return real_call(*args, **kw)

    def counting_step(b, parts):
        n0 = len(calls)
        real_step(b, parts)
        per_step.append(calls[n0:])

    monkeypatch.setattr(ops, "vfl_grad", counting_call)
    monkeypatch.setattr(te, "_pipe_step", counting_step)
    _port_epoch(te, kind, algo, wq, idx, state=state)
    rows = KINDS[kind] * BATCH
    assert per_step == [[("fused", rows)]] * (STEPS - 1)
    assert calls == [("forward", None)] + [("fused", rows)] * (STEPS - 1) \
        + [("backward", None)]


@pytest.mark.parametrize("multi", [False, True], ids=["pipelined", "both"])
@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_train_pipelined_fused_matches_reference_trainer(ds, layout, prob,
                                                         algo, multi):
    kw = dict(algo=algo, epochs=3, lr=0.3, batch=BATCH, seed=7,
              pipelined=True, multi_dominator=multi, device="cpu")
    ref = algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    fused = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                             engine="fused", **kw)
    np.testing.assert_allclose(fused.w, ref.w, atol=1e-5, rtol=0)
    assert len(fused.history) == len(ref.history) == 3
    for hf, hr in zip(fused.history, ref.history):
        assert abs(hf["objective"] - hr["objective"]) < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("kind", list(KINDS))
def test_cuda_pipelined_epochs_match_cpu_without_a_sync(cuda_device, ds,
                                                        layout, prob, kind,
                                                        mode):
    """On the card a pipelined epoch is an eager prologue, replays of one
    captured interior step and an eager epilogue: it runs under
    ``set_sync_debug_mode("error")``, each captured step launches
    ``vfl_fused_split`` once and nothing else of the kernel, the epoch
    replays bit for bit and equals the CPU engine to float tolerance."""
    from repro_torch.kernels import vfl_grad as vg
    cfg = engine.EngineConfig(secure=mode)
    ec = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device="cpu")
    eg = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device=cuda_device)
    idx = algorithms.epoch_indices(0, 0, ec.n, KINDS[kind] * BATCH, STEPS)
    idg = idx.to(cuda_device)
    w0 = ec.pack_w(0.1 * np.random.default_rng(0).standard_normal(D))
    w0g = w0.to(cuda_device)              # the copy in syncs: not in the run

    def run(eng, w, ix):
        w1 = _port_epoch(eng, kind, "sgd", w, ix, (0,))[0]
        mu = eng.full_gradient(w1, (1,))
        w2 = _port_epoch(eng, kind, "svrg", w1, ix, (2,), (w1, mu))[0]
        tab, avg = eng.saga_init(w2, (3,))
        return (w1, mu, w2, tab, avg) + _port_epoch(eng, kind, "saga", w2,
                                                    ix, (4,), (tab, avg))

    for _ in range(2):                    # capture, then reuse the graphs
        vg.KERNEL.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(eg, w0g, idg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert vg.KERNEL.launches == {
            "vfl_forward_narrow": 3 + 2, "vfl_forward_wide": 0,
            "vfl_backward_rows": 3 + 2, "vfl_backward_reduce": 0,
            "vfl_fused_split": 3 * (STEPS - 1)}
    loops = [lp for (name, _), lp in eg._loops.items()
             if name.startswith(kind)]
    assert len(loops) == 3
    assert all(lp.per_step == {"vfl_fused_split": 1} for lp in loops)
    again = run(eg, w0g, idg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, c in zip(got, run(ec, w0, idx)):
        torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=0)
