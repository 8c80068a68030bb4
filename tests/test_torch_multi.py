"""The port's multi-dominator epochs against the JAX package.

* ``multi_{sgd,svrg,saga}_epoch`` (all m = layout.m active parties update
  in every round) against the JAX ``FusedEngine``'s on the same data and
  the same (steps, m·B) schedule (the reference's own
  ``_batch_indices(key, n, m*batch, steps)``, as its epochs draw it): at
  1e-6 with ``secure="off"`` and at 1e-5 with masks (the two packages'
  masks differ, so they agree to the mask residue);
* each against the port's own oracle at 1e-6;
* m = 1 degenerates to the single-dominator epoch, and the masks are
  lossless (``two_tree`` and ``ring`` against ``off`` at 1e-5);
* ``train(multi_dominator=True, engine="fused")`` against
  ``engine="reference"`` over 3 epochs at 1e-5;
* the ``cuda``-marked test runs the epochs on the card, each under
  ``torch.cuda.set_sync_debug_mode("error")``, against the CPU engine.

Sizes are those of ``tests/test_torch_train.py``: the D = 50 logistic set
over q = 8 parties with m = 3 (uneven widths), batch 32, 25 steps.  JAX is
imported inside fixtures, so the file collects where only the port is
installed.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, engine, losses
from repro_torch.data import classification_dataset

D, Q, M, BATCH, STEPS, LR = 50, 8, 3, 32, 25, 0.5
SECURE = ("off", "two_tree", "ring")
ATOL = {"off": 1e-6, "two_tree": 1e-5, "ring": 1e-5}


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


def _start(jx, je, seed):
    """A JAX key, the (steps, m·B) schedule the JAX multi-dominator epochs
    draw from it, and a nonzero starting iterate on both sides."""
    key = jx.jax.random.PRNGKey(seed)
    idx = np.array(jx.alg._batch_indices(key, je.n, M * BATCH, STEPS))
    w0 = 0.1 * np.random.default_rng(seed).standard_normal(D)
    jwq = je.pack_w(w0.astype(np.float32))
    return key, idx, jwq, convert.linear_iterate(np.asarray(jwq),
                                                 device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _run_jax(je, algo, jwq, key):
    """The JAX multi-dominator epoch of ``algo`` from ``jwq``, with the
    SVRG / SAGA state it starts from."""
    if algo == "sgd":
        return je.multi_sgd_epoch(jwq, LR, key, BATCH, STEPS), ()
    if algo == "svrg":
        jmu = je.full_gradient(jwq, key)
        return je.multi_svrg_epoch(jwq, jwq, jmu, LR, key, BATCH, STEPS), \
            (jmu,)
    jtab, javg = je.saga_init(jwq, key)
    return je.multi_saga_epoch(jwq, jtab, javg, LR, key, BATCH, STEPS), \
        (jtab, javg)


@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_multi_epoch_matches_jax(engines, jx, algo, mode):
    je, te = engines(mode)
    key, idx, jwq, twq = _start(jx, je, 40)
    assert any(len(set(row)) < M * BATCH for row in idx.tolist()), \
        "the schedule should repeat an id in some step"
    want, state = _run_jax(je, algo, jwq, key)
    if algo == "sgd":
        got = te.multi_sgd_epoch(twq, LR, idx, (40,))
    elif algo == "svrg":
        snap, mu = convert.svrg_state(np.asarray(jwq), np.asarray(state[0]),
                                      device="cpu")
        got = te.multi_svrg_epoch(twq, snap, mu, LR, idx, (40,))
    else:
        tab, avg = convert.saga_state(*map(np.asarray, state), device="cpu")
        got = te.multi_saga_epoch(twq, tab, avg, LR, idx, (40,))
    for g, w in zip(got if algo == "saga" else (got,),
                    want if algo == "saga" else (want,)):
        _close(g, w, ATOL[mode])


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_multi_epochs_match_port_oracle(ds, layout, prob, engines, jx, algo):
    """The engine's party-stacked epoch equals the oracle's pooled one."""
    _, te = engines("off")
    _, idx, _, twq = _start(jx, engines("off")[0], 41)
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    w = torch.from_numpy(te.unpack_w(twq))
    mask = torch.from_numpy(layout.update_mask(D, False))
    idx = torch.from_numpy(idx)
    if algo == "sgd":
        got = te.multi_sgd_epoch(twq, LR, idx)
        want = algorithms.multi_sgd_epoch(prob, w, x, y, LR, mask, idx, M)
    elif algo == "svrg":
        muq = te.full_gradient(twq)
        mu = algorithms.full_gradient(prob, w, x, y)
        got = te.multi_svrg_epoch(twq, twq, muq, LR, idx)
        want = algorithms.multi_svrg_epoch(prob, w, w, mu, x, y, LR, mask,
                                           idx, M)
    else:
        tabq, avgq = te.saga_init(twq)
        tab, avg = algorithms.saga_init(prob, w, x, y)
        got, tabq, avgq = te.multi_saga_epoch(twq, tabq, avgq, LR, idx)
        want, tab, avg = algorithms.multi_saga_epoch(prob, w, tab, avg, x, y,
                                                     LR, mask, idx, M)
        _close(tabq, tab.expand(Q, -1), 1e-6)
        _close(te.unpack_w(avgq), avg, 1e-6)
    _close(te.unpack_w(got), want, 1e-6)


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_multi_m1_degenerates_to_single_dominator(ds, prob, algo):
    """m = 1: the multi-dominator epoch is the single-dominator epoch on
    the same schedule."""
    layout1 = algorithms.PartyLayout.even(D, Q, 1)
    te = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout1,
                            device="cpu")
    idx = algorithms.epoch_indices(42, 0, te.n, BATCH, STEPS)
    wq = te.pack_w(0.1 * np.random.default_rng(42).standard_normal(D))
    if algo == "sgd":
        pair = (te.multi_sgd_epoch(wq, LR, idx), te.sgd_epoch(wq, LR, idx))
    elif algo == "svrg":
        mu = te.full_gradient(wq)
        pair = (te.multi_svrg_epoch(wq, wq, mu, LR, idx),
                te.svrg_epoch(wq, wq, mu, LR, idx))
    else:
        tab, avg = te.saga_init(wq)
        pair = (te.multi_saga_epoch(wq, tab, avg, LR, idx),
                te.saga_epoch(wq, tab, avg, LR, idx))
    for multi, single in zip(*(p if algo == "saga" else (p,) for p in pair)):
        _close(multi, single, 1e-6)


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_multi_secure_modes_are_lossless(engines, jx, algo):
    idx = _start(jx, engines("off")[0], 43)[1]
    out = {}
    for mode in SECURE:
        te = engines(mode)[1]
        wq = te.pack_w(0.1 * np.random.default_rng(43).standard_normal(D))
        if algo == "sgd":
            out[mode] = te.multi_sgd_epoch(wq, LR, idx, (43,))
        elif algo == "svrg":
            mu = te.full_gradient(wq, (43,))
            out[mode] = te.multi_svrg_epoch(wq, wq, mu, LR, idx, (43,))
        else:
            tab, avg = te.saga_init(wq, (43,))
            out[mode] = te.multi_saga_epoch(wq, tab, avg, LR, idx, (43,))[0]
    for mode in ("two_tree", "ring"):
        _close(out[mode], out["off"], 1e-5)


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_train_multi_fused_matches_reference_trainer(ds, layout, prob, algo):
    kw = dict(algo=algo, epochs=3, lr=0.3, batch=BATCH, seed=7,
              multi_dominator=True, device="cpu")
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
def test_cuda_multi_epochs_match_cpu_without_a_sync(cuda_device, ds, layout,
                                                    prob, mode):
    """On the card each multi-dominator epoch is a CUDA-graph replay of
    its step: it runs under ``set_sync_debug_mode("error")``, launches one
    forward and one backward per step, replays bit for bit, and equals
    the CPU engine to float tolerance."""
    from repro_torch.kernels import vfl_grad as vg
    cfg = engine.EngineConfig(secure=mode)
    ec = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device="cpu")
    eg = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device=cuda_device)
    idx = algorithms.epoch_indices(0, 0, ec.n, M * BATCH, STEPS)
    idg = idx.to(cuda_device)
    w0 = ec.pack_w(0.1 * np.random.default_rng(0).standard_normal(D))
    w0g = w0.to(cuda_device)              # the copy in syncs: not in the run

    def run(eng, w, ix):
        w1 = eng.multi_sgd_epoch(w, LR, ix, (0,))
        mu = eng.full_gradient(w1, (1,))
        w2 = eng.multi_svrg_epoch(w1, w1, mu, LR, ix, (2,))
        tab, avg = eng.saga_init(w2, (3,))
        return (w1, mu, w2, tab, avg) + eng.multi_saga_epoch(
            w2, tab, avg, LR, ix, (4,))

    for _ in range(2):                    # capture, then reuse the graphs
        vg.KERNEL.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(eg, w0g, idg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert vg.KERNEL.launches == {
            "vfl_forward_narrow": 3 * STEPS + 2, "vfl_forward_wide": 0,
            "vfl_backward_rows": 3 * STEPS + 2, "vfl_backward_reduce": 0,
            "vfl_fused_split": 0}
    again = run(eg, w0g, idg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, c in zip(got, run(ec, w0, idx)):
        torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=0)
