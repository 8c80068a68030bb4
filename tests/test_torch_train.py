"""The port's linear training against the JAX package.

* Each port epoch (``sgd``, ``svrg`` with ``full_gradient``, ``saga``
  with ``saga_init``) against the JAX ``FusedEngine``'s on the same data
  and the same index schedule (the reference's own
  ``_batch_indices(key, n, batch, steps)``, as its epochs draw it), with
  the state carried across by ``convert``: at 1e-6 with ``secure="off"``
  (the bound of ``tests/test_engine.py``) and at 1e-5 with masks (the two
  packages' masks differ, so they agree to the mask residue).
* Each port epoch against the port's own oracle at 1e-6, and
  ``train(engine="fused")`` against ``train(engine="reference")`` over 3
  epochs at 1e-5, as ``tests/test_engine.py`` does for JAX.
* The ``cuda``-marked test runs the epochs on the card, each under
  ``torch.cuda.set_sync_debug_mode("error")``, against the CPU engine.

Sizes are those of ``tests/test_engine.py``: the D = 50 logistic set over
q = 8 parties with m = 3 (uneven widths, so the pad path runs), batch 32,
25 steps.  JAX is imported inside fixtures, so the file collects where
only the port is installed.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, engine, losses
from repro_torch.data import classification_dataset

D, BATCH, STEPS, LR = 50, 32, 25, 0.5
SECURE = {"off": dict(secure="off"),
          "two_tree": dict(secure="two_tree"),
          "two_tree_sf": dict(secure="two_tree", schedule_faithful=True),
          "ring": dict(secure="ring")}
ATOL = {"off": 1e-6, "two_tree": 1e-5, "two_tree_sf": 1e-5, "ring": 1e-5}


@pytest.fixture(scope="module")
def ds():
    return classification_dataset("eng", 1000, D, seed=3, noise=0.4)


@pytest.fixture(scope="module")
def layout():
    return algorithms.PartyLayout.even(D, 8, 3)


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
                                 layout=jalg.PartyLayout.even(D, 8, 3))


@pytest.fixture(scope="module")
def engines(ds, layout, prob, jx):
    """(JAX engine, port engine) per (secure mode, active_only), built
    once: a JAX engine caches its compiled epochs."""
    cache = {}

    def get(mode, active_only=False):
        if (mode, active_only) not in cache:
            je = jx.eng.FusedEngine(jx.prob, ds.x_train, ds.y_train,
                                    jx.layout,
                                    jx.eng.EngineConfig(**SECURE[mode]),
                                    active_only=active_only)
            te = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout,
                                    engine.EngineConfig(**SECURE[mode]),
                                    active_only=active_only, device="cpu")
            cache[mode, active_only] = je, te
        return cache[mode, active_only]

    return get


def _start(jx, je, seed):
    """A JAX key, the schedule the JAX epochs draw from it, and a nonzero
    starting iterate on both sides (the port's carried by ``convert``)."""
    key = jx.jax.random.PRNGKey(seed)
    n = je.n
    idx = np.array(jx.alg._batch_indices(key, n, BATCH, STEPS))
    w0 = 0.1 * np.random.default_rng(seed).standard_normal(D)
    jwq = je.pack_w(w0.astype(np.float32))
    return key, idx, jwq, convert.linear_iterate(np.asarray(jwq),
                                                 device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("mode", list(SECURE))
def test_sgd_epoch_matches_jax(engines, jx, mode):
    je, te = engines(mode)
    key, idx, jwq, twq = _start(jx, je, 0)
    jw = je.sgd_epoch(jwq, LR, key, BATCH, STEPS)
    tw = te.sgd_epoch(twq, LR, idx, (0,))
    _close(tw, jw, ATOL[mode])


@pytest.mark.parametrize("mode", list(SECURE))
def test_svrg_epoch_matches_jax(engines, jx, mode):
    je, te = engines(mode)
    key, idx, jwq, twq = _start(jx, je, 1)
    jmu = je.full_gradient(jwq, key)
    _close(te.full_gradient(twq, (1,)), jmu, ATOL[mode])
    snap, mu = convert.svrg_state(np.asarray(jwq), np.asarray(jmu),
                                  device="cpu")
    jw = je.svrg_epoch(jwq, jwq, jmu, LR, key, BATCH, STEPS)
    tw = te.svrg_epoch(twq, snap, mu, LR, idx, (1,))
    _close(tw, jw, ATOL[mode])


@pytest.mark.parametrize("mode", list(SECURE))
def test_saga_epoch_matches_jax(engines, jx, mode):
    je, te = engines(mode)
    key, idx, jwq, twq = _start(jx, je, 2)
    assert any(len(set(row)) < BATCH for row in idx.tolist()), \
        "the schedule should repeat an id in some minibatch"
    jtab, javg = je.saga_init(jwq, key)
    ttab, tavg = te.saga_init(twq, (2,))
    _close(ttab, jtab, ATOL[mode])
    _close(tavg, javg, ATOL[mode])
    tab, avg = convert.saga_state(np.asarray(jtab), np.asarray(javg),
                                  device="cpu")
    jw, jtab2, javg2 = je.saga_epoch(jwq, jtab, javg, LR, key, BATCH, STEPS)
    tw, ttab2, tavg2 = te.saga_epoch(twq, tab, avg, LR, idx, (2,))
    for got, want in ((tw, jw), (ttab2, jtab2), (tavg2, javg2)):
        _close(got, want, ATOL[mode])


def test_active_only_freezes_passive_blocks(engines, jx, layout):
    je, te = engines("off", active_only=True)
    key, idx, jwq, twq = _start(jx, je, 3)
    tw = te.sgd_epoch(twq, LR, idx)
    _close(tw, je.sgd_epoch(jwq, LR, key, BATCH, STEPS), ATOL["off"])
    assert torch.equal(tw[layout.m:], twq[layout.m:])
    assert not torch.equal(tw[: layout.m], twq[: layout.m])


def test_objective_matches_jax(engines, jx):
    je, te = engines("off")
    _, _, jwq, twq = _start(jx, je, 4)
    assert abs(te.objective(twq) - je.objective(jwq)) < 1e-6


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_epochs_match_port_oracle(ds, layout, prob, engines, jx, algo):
    """The engine's party-stacked epoch equals the oracle's pooled one."""
    _, te = engines("off")
    _, idx, _, twq = _start(jx, engines("off")[0], 5)
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    w = torch.from_numpy(te.unpack_w(twq))
    mask = torch.from_numpy(layout.update_mask(D, False))
    idx = torch.from_numpy(idx)
    if algo == "sgd":
        got = te.sgd_epoch(twq, LR, idx)
        want = algorithms.sgd_epoch(prob, w, x, y, LR, mask, idx)
    elif algo == "svrg":
        muq = te.full_gradient(twq)
        mu = algorithms.full_gradient(prob, w, x, y)
        _close(te.unpack_w(muq), mu, 1e-6)
        got = te.svrg_epoch(twq, twq, muq, LR, idx)
        want = algorithms.svrg_epoch(prob, w, w, mu, x, y, LR, mask, idx)
    else:
        tabq, avgq = te.saga_init(twq)
        tab, avg = algorithms.saga_init(prob, w, x, y)
        got, tabq, avgq = te.saga_epoch(twq, tabq, avgq, LR, idx)
        want, tab, avg = algorithms.saga_epoch(prob, w, tab, avg, x, y, LR,
                                               mask, idx)
        _close(tabq, tab.expand(8, -1), 1e-6)
        _close(te.unpack_w(avgq), avg, 1e-6)
    _close(te.unpack_w(got), want, 1e-6)


@pytest.mark.parametrize("algo", ["sgd", "svrg", "saga"])
def test_train_fused_matches_reference_trainer(ds, layout, prob, algo):
    kw = dict(algo=algo, epochs=3, lr=0.3, batch=BATCH, seed=7,
              device="cpu")
    ref = algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    fused = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                             engine="fused", **kw)
    np.testing.assert_allclose(fused.w, ref.w, atol=1e-5, rtol=0)
    assert len(fused.history) == len(ref.history) == 3
    for hf, hr in zip(fused.history, ref.history):
        assert abs(hf["objective"] - hr["objective"]) < 1e-5
    assert ref.history[-1]["objective"] < ref.history[0]["objective"]


def test_train_secure_fused_matches_off(ds, layout, prob):
    kw = dict(algo="svrg", epochs=2, lr=0.3, batch=BATCH, seed=8,
              device="cpu", engine="fused")
    off = algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    for mode in ("two_tree", "ring"):
        sec = algorithms.train(
            prob, ds.x_train, ds.y_train, layout,
            engine_config=engine.EngineConfig(**SECURE[mode]), **kw)
        np.testing.assert_allclose(sec.w, off.w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("flag,item", [
    (dict(deep=True, checkpoint_dir="ckpt"), "A9"), (dict(checkpoint_dir="ckpt"), "A9"),
    (dict(resume_from="ckpt"), "A9"), (dict(supervise=True), "A10")])
def test_unported_train_options_raise(ds, layout, prob, tmp_path, flag,
                                      item):
    """The options that raised ``NotImplementedError`` naming ROADMAP
    ``item`` before it was ported now run, and raise where misused: a
    resume from a directory with no bundle, a supervised run without a
    checkpoint directory.  A checkpointed epoch leaves its bundle."""
    from repro_torch.checkpoint import ckpt
    flag = {k: str(tmp_path / v) if k in ("checkpoint_dir", "resume_from")
            else v for k, v in flag.items()}
    kw = dict(epochs=1, device="cpu", **flag)
    if "resume_from" in flag:
        with pytest.raises(FileNotFoundError, match="no checkpoint bundle"):
            algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    elif "supervise" in flag:
        with pytest.raises(ValueError, match="checkpoint_dir"):
            algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    else:
        algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
        assert ckpt.checkpoint_steps(flag["checkpoint_dir"]) == [1]


def test_epoch_indices_are_device_independent_and_seeded():
    a = algorithms.epoch_indices(3, 1, 800, BATCH, STEPS)
    assert a.dtype == torch.int64 and tuple(a.shape) == (STEPS, BATCH)
    assert torch.equal(a, algorithms.epoch_indices(3, 1, 800, BATCH, STEPS))
    assert not torch.equal(a, algorithms.epoch_indices(3, 2, 800, BATCH,
                                                       STEPS))
    assert int(a.min()) >= 0 and int(a.max()) < 800


def test_last_occurrence_wins():
    ids = torch.tensor([4, 1, 4, 2, 1, 4])
    assert algorithms.last_occurrence(ids).tolist() == [5, 4, 5, 3, 4, 5]
    tab = torch.zeros(6)
    tab[ids] = torch.arange(6.0)[algorithms.last_occurrence(ids)]
    assert tab.tolist() == [0, 4, 3, 0, 5, 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(SECURE))
def test_cuda_epochs_match_cpu_without_a_sync(cuda_device, ds, layout, prob,
                                              mode):
    """On the card each epoch is a CUDA-graph replay of its step: it runs
    under ``set_sync_debug_mode("error")``, launches the kernels as the
    step structure implies, replays bit for bit, and equals the CPU
    engine to float tolerance."""
    from repro_torch.kernels import vfl_grad as vg
    cfg = engine.EngineConfig(**SECURE[mode])
    ec = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device="cpu")
    eg = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device=cuda_device)
    idx = algorithms.epoch_indices(0, 0, ec.n, BATCH, STEPS)
    idg = idx.to(cuda_device)
    w0 = ec.pack_w(0.1 * np.random.default_rng(0).standard_normal(D))
    w0g = w0.to(cuda_device)              # the copy in syncs: not in the run

    def run(eng, w, ix):
        w1 = eng.sgd_epoch(w, LR, ix, (0,))
        mu = eng.full_gradient(w1, (1,))
        w2 = eng.svrg_epoch(w1, w1, mu, LR, ix, (2,))
        tab, avg = eng.saga_init(w2, (3,))
        return (w1, mu, w2, tab, avg) + eng.saga_epoch(w2, tab, avg, LR, ix,
                                                       (4,))

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
