"""The port's bounded-delay (stale-gradient) linear epochs against the JAX
package.

Party ℓ applies at global step t the BUM gradient of step t − d_ℓ from a
ring of the last τ + 1 gradients (per (party, dominator) pair in the
multi-dominator forms; the pipelined forms age the τ = 1 stale-read
gradient).

* the numpy delay schedules equal the reference's integers, with every
  active party's delay and every dominator's own diagonal entry zero;
* the four oracles against the JAX oracles at 1e-6 over two chained
  epochs (the state carried between them);
* the four ``FusedEngine`` delayed epochs against the JAX engine's on its
  own ``_batch_indices`` schedule over two chained epochs — ``wq``,
  ``bufq`` and the returned counter — at 1e-6 with ``secure="off"`` and
  1e-5 with masks, and against the port's own oracle at 1e-6;
* at τ = 0 each delayed kind equals its fresh counterpart (bit for bit
  with one dominator, within 4 float32 ulps with m);
* ``active_only=True`` leaves the passive blocks at 0;
* a fresh delayed step makes one forward and one backward
  ``ops.vfl_grad`` call, an interior pipelined step exactly one fused
  call with ``split``;
* the runners against a loop of the port's oracles over the same
  ``epoch_indices`` schedules at 1e-5, and ``run_delayed_fused`` at
  τ = 0 against ``train(algo="sgd", engine="fused")``;
* the ``cuda``-marked test runs the four epochs on the card under
  ``torch.cuda.set_sync_debug_mode("error")`` against the CPU engine, and
  checks each captured step's launches and that the ring slot moves
  between replays.

Sizes are those of ``tests/test_torch_pipelined.py``: the D = 50 logistic
set over q = 8 parties with m = 3, batch 32, 25 steps, and τ = 3.  JAX is
imported inside fixtures.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, engine, losses, staleness
from repro_torch.data import classification_dataset
from repro_torch.kernels import ops

D, Q, M, BATCH, STEPS, LR, TAU = 50, 8, 3, 32, 25, 0.5, 3
SECURE = ("off", "two_tree", "ring")
ATOL = {"off": 1e-6, "two_tree": 1e-5, "ring": 1e-5}
# kind -> (multi-dominator, pipelined)
KINDS = {"delayed": (False, False), "multi_delayed": (True, False),
         "pipelined_delayed": (False, True),
         "multi_pipelined_delayed": (True, True)}
FRESH = {"delayed": "sgd_epoch", "multi_delayed": "multi_sgd_epoch",
         "pipelined_delayed": "pipelined_sgd_epoch",
         "multi_pipelined_delayed": "multi_pipelined_sgd_epoch"}
ORACLE = {"delayed": "delayed_sgd_epoch",
          "multi_delayed": "delayed_multi_sgd_epoch",
          "pipelined_delayed": "pipelined_delayed_sgd_epoch",
          "multi_pipelined_delayed": "pipelined_delayed_multi_sgd_epoch"}


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
    import jax.numpy as jnp
    from repro.core import algorithms as jalg
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    from repro.core import staleness as jst
    return types.SimpleNamespace(jax=jax, jnp=jnp, alg=jalg, eng=jeng,
                                 st=jst, prob=jloss.logistic_l2(),
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


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _rows(kind):
    return (M if KINDS[kind][0] else 1) * BATCH


def _party_delays(layout, kind, tau=TAU, seed=1):
    """The engine's delays: (q,) per party, or (q, m) per (party,
    dominator) for the multi-dominator kinds."""
    if KINDS[kind][0]:
        return staleness.party_dominator_delays(layout, tau, seed)
    return staleness.party_delay_values(layout, tau, seed)


def _ring(te, kind, tau=TAU):
    return torch.zeros((Q, tau + 1, te.dp)
                       + ((M,) if KINDS[kind][0] else ()))


def _w0(seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(D)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# delay schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0, 1, 3, 6])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_delay_schedules_match_reference(jx, layout, seed, tau):
    for name, args in (("party_delay_values", (tau, seed)),
                       ("party_delays", (D, tau, seed)),
                       ("party_dominator_delays", (tau, seed)),
                       ("dominator_delays_by_coord", (D, tau, seed))):
        got = getattr(staleness, name)(layout, *args)
        want = getattr(jx.st, name)(jx.layout, *args)
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    per_party = staleness.party_delay_values(layout, tau, seed)
    dd = staleness.party_dominator_delays(layout, tau, seed)
    assert not per_party[:M].any()                 # active parties fresh
    assert not np.diagonal(dd).any()               # own diagonal fresh
    assert 0 <= per_party.min() and per_party.max() <= tau
    assert 0 <= dd.min() and dd.max() <= tau


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_oracles_match_jax(ds, layout, prob, jx, kind):
    """Two chained epochs of each oracle on the same schedules, the state
    (iterate, ring, counter) carried between them."""
    multi, _ = KINDS[kind]
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    mask = layout.update_mask(D, True)             # frozen passive blocks
    if multi:
        delays = staleness.dominator_delays_by_coord(layout, D, TAU, 1)
        jstate = jx.st.init_multi_state(D, TAU, M)
        state = staleness.init_multi_state(D, TAU, M, device="cpu")
        extra = (M,)
    else:
        delays = staleness.party_delays(layout, D, TAU, 1)
        jstate = jx.st.init_state(D, TAU)
        state = staleness.init_state(D, TAU, device="cpu")
        extra = ()
    w0 = _w0(60)
    jstate.w, state.w = jx.jnp.asarray(w0), torch.from_numpy(w0)
    jfn, fn = getattr(jx.st, ORACLE[kind]), getattr(staleness, ORACLE[kind])
    for k in (61, 62):
        key = jx.jax.random.PRNGKey(k)
        idx = np.array(jx.jax.random.randint(key, (STEPS, _rows(kind)), 0,
                                             ds.x_train.shape[0]))
        jstate = jfn(jx.prob, jstate, ds.x_train, ds.y_train, LR,
                     jx.jnp.asarray(delays), key, BATCH, STEPS, TAU, *extra,
                     mask=jx.jnp.asarray(mask))
        state = fn(prob, state, x, y, LR, torch.from_numpy(delays),
                   torch.from_numpy(idx), *extra,
                   mask=torch.from_numpy(mask))
        _close(state.w, jstate.w, 1e-6)
        _close(state.buf, jstate.buf, 1e-6)
        assert int(state.t) == int(jstate.t)
    assert int(state.t) == 2 * STEPS
    assert not state.w[layout.bounds[M][0]:].sub(
        torch.from_numpy(w0[layout.bounds[M][0]:])).any()


# ---------------------------------------------------------------------------
# the engine's delayed epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", SECURE)
@pytest.mark.parametrize("kind", list(KINDS))
def test_delayed_epochs_match_jax(engines, layout, jx, kind, mode):
    """Two chained epochs on the JAX engine's own schedules: the iterate,
    the ring and the returned counter."""
    je, te = engines(mode)
    name = f"{kind}_sgd_epoch"
    delays = _party_delays(layout, kind)
    jwq = je.pack_w(_w0(70))
    jbuf = jx.jnp.zeros(tuple(_ring(te, kind).shape))
    jt = jx.jnp.zeros((), jx.jnp.int32)
    twq = convert.linear_iterate(np.asarray(jwq), device="cpu")
    tbuf, tt = _ring(te, kind), 0
    for k in (71, 72):
        key = jx.jax.random.PRNGKey(k)
        idx = np.array(jx.alg._batch_indices(key, je.n, _rows(kind), STEPS))
        jwq, jbuf, jt = getattr(je, name)(jwq, jbuf, jt,
                                          jx.jnp.asarray(delays), LR, key,
                                          BATCH, STEPS, TAU)
        twq, tbuf, tt = getattr(te, name)(twq, tbuf, tt, delays, LR,
                                          torch.from_numpy(idx), TAU, (k,))
        _close(twq, jwq, ATOL[mode])
        _close(tbuf, jbuf, ATOL[mode])
        assert tt.dtype == torch.int64 and int(tt) == int(jt)
    assert int(tt) == 2 * STEPS


@pytest.mark.parametrize("kind", list(KINDS))
def test_delayed_epochs_match_port_oracle(ds, layout, prob, engines, kind):
    """The engine's party-stacked epoch equals the oracle's pooled one
    (the ring unpacked per slot, per dominator)."""
    te = engines("off")[1]
    multi, _ = KINDS[kind]
    idx = algorithms.epoch_indices(80, 0, te.n, _rows(kind), STEPS)
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    w0 = _w0(80)
    wq, bufq, t = getattr(te, f"{kind}_sgd_epoch")(
        te.pack_w(w0), _ring(te, kind), 0, _party_delays(layout, kind), LR,
        idx, TAU)
    if multi:
        state = staleness.init_multi_state(D, TAU, M, device="cpu")
        delays = staleness.dominator_delays_by_coord(layout, D, TAU, 1)
    else:
        state = staleness.init_state(D, TAU, device="cpu")
        delays = staleness.party_delays(layout, D, TAU, 1)
    state.w = torch.from_numpy(w0)
    want = getattr(staleness, ORACLE[kind])(
        prob, state, x, y, LR, torch.from_numpy(delays), idx,
        *((M,) if multi else ()),
        mask=torch.from_numpy(layout.update_mask(D, False)))
    _close(te.unpack_w(wq), want.w, 1e-6)
    for s in range(TAU + 1):
        ring = bufq[:, s]
        cols = [ring[..., j] for j in range(M)] if multi else [ring]
        got = np.stack([te.unpack_w(c) for c in cols], -1)
        _close(got, want.buf[s].reshape(D, -1), 1e-6)
    assert int(t) == int(want.t) == STEPS


@pytest.mark.parametrize("kind", list(KINDS))
def test_tau0_equals_fresh_epoch(layout, engines, kind):
    """With no delay the ring hands each step its own gradient back: the
    delayed epoch is its fresh counterpart, bit for bit with one
    dominator.  With m the fresh step adds m·λ∇g(w) to the summed columns
    and the delayed step sums the m columns that each carry λ∇g(w), which
    rounds differently: within 4 float32 ulps of the iterate's scale."""
    te = engines("off")[1]
    multi, _ = KINDS[kind]
    idx = algorithms.epoch_indices(90, 0, te.n, _rows(kind), STEPS)
    wq = te.pack_w(_w0(90))
    delays = _party_delays(layout, kind, tau=0)
    got, _, _ = getattr(te, f"{kind}_sgd_epoch")(
        wq, _ring(te, kind, tau=0), 0, delays, LR, idx, 0, (9,))
    want = getattr(te, FRESH[kind])(wq, LR, idx, (9,))
    if multi:
        eps = torch.finfo(torch.float32).eps
        _close(got, want, 4 * eps * float(want.abs().max()))
        assert not torch.equal(got, want)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_active_only_keeps_passive_blocks_at_zero(ds, layout, prob, kind):
    multi, pipelined = KINDS[kind]
    run = staleness.run_delayed_multi_fused if multi \
        else staleness.run_delayed_fused
    w = run(prob, ds.x_train, ds.y_train, layout, TAU, epochs=1, lr=LR,
            batch=BATCH, seed=2, active_only=True, pipelined=pipelined,
            device="cpu")
    passive = layout.bounds[M][0]
    assert not w[passive:].any()
    assert np.abs(w[:passive]).min() > 0


@pytest.mark.parametrize("kind", list(KINDS))
def test_step_kernel_calls(layout, engines, monkeypatch, kind):
    """A fresh delayed step calls ``ops.vfl_grad`` once forward and once
    backward; an interior pipelined step exactly once, fused with
    ``split``; the pipelined prologue is one forward call and the
    epilogue one backward call."""
    te = engines("off")[1]
    _, pipelined = KINDS[kind]
    idx = algorithms.epoch_indices(95, 0, te.n, _rows(kind), STEPS)
    calls, per_step = [], []
    real_call = ops.vfl_grad
    step_name = "_pipe_step" if pipelined else "_fresh_step"
    real_step = getattr(te, step_name)

    def counting_call(*args, **kw):
        calls.append((kw.get("mode", "forward"), kw.get("split")))
        return real_call(*args, **kw)

    def counting_step(b, parts):
        n0 = len(calls)
        real_step(b, parts)
        per_step.append(calls[n0:])

    monkeypatch.setattr(ops, "vfl_grad", counting_call)
    monkeypatch.setattr(te, step_name, counting_step)
    getattr(te, f"{kind}_sgd_epoch")(te.pack_w(_w0(95)), _ring(te, kind),
                                     0, _party_delays(layout, kind), LR,
                                     idx, TAU)
    if pipelined:
        assert per_step == [[("fused", _rows(kind))]] * (STEPS - 1)
        assert calls == [("forward", None)] \
            + [("fused", _rows(kind))] * (STEPS - 1) + [("backward", None)]
    else:
        assert per_step == [[("forward", None), ("backward", None)]] * STEPS


def test_ring_shape_must_match_tau(layout, engines):
    te = engines("off")[1]
    idx = algorithms.epoch_indices(96, 0, te.n, BATCH, STEPS)
    with pytest.raises(ValueError, match="tau=2 needs 3"):
        te.delayed_sgd_epoch(te.pack_w(_w0(96)), _ring(te, "delayed"), 0,
                             _party_delays(layout, "delayed"), LR, idx, 2)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_runners_match_oracle_loop(ds, layout, prob, multi, pipelined):
    epochs, seed = 2, 4
    run = staleness.run_delayed_multi_fused if multi \
        else staleness.run_delayed_fused
    got = run(prob, ds.x_train, ds.y_train, layout, TAU, epochs, LR, BATCH,
              seed=seed, pipelined=pipelined, device="cpu")
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    n = x.shape[0]
    if multi:
        state = staleness.init_multi_state(D, TAU, M, device="cpu")
        delays = staleness.dominator_delays_by_coord(layout, D, TAU, seed)
        fn = staleness.pipelined_delayed_multi_sgd_epoch if pipelined \
            else staleness.delayed_multi_sgd_epoch
        extra = (M,)
    else:
        state = staleness.init_state(D, TAU, device="cpu")
        delays = staleness.party_delays(layout, D, TAU, seed)
        fn = staleness.pipelined_delayed_sgd_epoch if pipelined \
            else staleness.delayed_sgd_epoch
        extra = ()
    mask = torch.from_numpy(layout.update_mask(D, False))
    for ep in range(epochs):
        idx = algorithms.epoch_indices(seed, ep, n,
                                       (M if multi else 1) * BATCH,
                                       n // BATCH)
        state = fn(prob, state, x, y, LR, torch.from_numpy(delays), idx,
                   *extra, mask=mask)
    _close(got, state.w, 1e-5)


def test_run_delayed_fused_at_tau0_is_train(ds, layout, prob):
    kw = dict(epochs=2, lr=LR, batch=BATCH, seed=5, device="cpu")
    got = staleness.run_delayed_fused(prob, ds.x_train, ds.y_train, layout,
                                      0, **kw)
    want = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                            algo="sgd", engine="fused", **kw)
    np.testing.assert_array_equal(got, want.w)


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
def test_cuda_delayed_epochs_match_cpu_without_a_sync(cuda_device, ds,
                                                      layout, prob, mode):
    """On the card each delayed epoch is an eager step and replays of one
    captured step: it runs under ``set_sync_debug_mode("error")``, each
    captured step launches the fresh step's programs (or
    ``vfl_fused_split`` alone), the ring slot moves between replays (the
    ring and the counter equal the CPU engine's), and a second run
    replays the first bit for bit."""
    from repro_torch.kernels import vfl_grad as vg
    steps = TAU + 3
    cfg = engine.EngineConfig(secure=mode)
    ec = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device="cpu")
    eg = engine.FusedEngine(prob, ds.x_train, ds.y_train, layout, cfg,
                            device=cuda_device)
    inputs = {}
    for kind in KINDS:
        idx = algorithms.epoch_indices(0, 0, ec.n, _rows(kind), steps)
        delays = torch.from_numpy(_party_delays(layout, kind)).long()
        inputs[kind] = (idx, ec.pack_w(_w0(0)), _ring(ec, kind), delays)
    ginputs = {k: tuple(a.to(cuda_device) for a in v)  # copies sync: not
               for k, v in inputs.items()}             # in the run

    def run(eng, ins):
        out = {}
        for i, (kind, (idx, wq, buf, delays)) in enumerate(ins.items()):
            fn = getattr(eng, f"{kind}_sgd_epoch")
            out[kind] = fn(wq, buf, 0, delays, LR, idx, TAU, (i,))
        return out

    for _ in range(2):                    # capture, then reuse the graphs
        vg.KERNEL.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(eg, ginputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert vg.KERNEL.launches == {
            "vfl_forward_narrow": 2 * steps + 2,
            "vfl_forward_wide": 0,
            "vfl_backward_rows": 2 * steps + 2,
            "vfl_backward_reduce": 0,
            "vfl_fused_split": 2 * (steps - 1)}
    for kind, (multi, pipelined) in KINDS.items():
        (loop,) = [lp for (name, _), lp in eg._loops.items()
                   if name == ("multi_" if multi else "")
                   + ("pipelined_" if pipelined else "") + f"delayed{TAU}"]
        assert loop.per_step == ({"vfl_fused_split": 1} if pipelined else
                                 {"vfl_forward_narrow": 1,
                                  "vfl_backward_rows": 1})
    again = run(eg, ginputs)
    want = run(ec, inputs)
    for kind in KINDS:
        assert all(torch.equal(a, b) for a, b in zip(got[kind],
                                                     again[kind]))
        for g, c in zip(got[kind], want[kind]):
            torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=0)
        assert int(got[kind][2]) == steps
