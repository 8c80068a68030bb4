"""The port's bounded-delay deep VFB² epochs against the JAX package.

Party ℓ applies at global step t its encoder gradients of step t − d_ℓ
from a ring of the last τ + 1 (per (party, dominator) pair in the
multi-dominator forms, each dominator's Jacobian-transpose slab apart);
the dominator-held head applies its gradient fresh.  The pipelined forms
ring the τ = 1 stale-read gradients.

* the port's oracles ``staleness.train_deep_delayed`` /
  ``train_deep_multi_delayed`` (both also pipelined) against the JAX
  oracles, handed the JAX key stream's params and schedules, at 1e-5 on
  every leaf;
* the engine's 4 deep delayed epochs against the JAX ``FusedEngine``'s
  over two chained epochs on its ``_batch_indices`` schedules: the
  iterate, every ring slot and the counter at 1e-5; and against the
  port's oracle;
* ``_bwd_doms_wide`` and ``_pipe_doms_wide`` (the kernel route: its plain
  version here) and ``_seg_contract`` against the JAX engine's, on its
  Pallas route (interpret mode) and its segment-einsum route;
* the runners against the port's oracle, on the card by default;
* τ = 0 against the fresh deep epochs; a delayed trajectory that differs
  from the fresh one; ``active_only`` freezes the passive encoders while
  their rings age; ``two_tree`` and ``ring`` within 1e-5 of ``off``;
* the ``ops.vfl_grad`` calls a step: 4 in a fresh step (multi: 2
  forwards and 2 per-dominator backwards over block-diagonal columns),
  exactly one split call in a pipelined interior step (multi: Mw =
  hidden beside Mθ = m·hidden);
* the ``cuda``-marked test runs the 4 kinds on the card under
  ``torch.cuda.set_sync_debug_mode("error")`` against the CPU engine.

Sizes are the reference's deep files' (``tests/test_deep_sched_engine.py``):
N = 600, D = 32, hidden 16, d_rep 8, batch 32, 2 epochs; q = 4 with
m = 2 at τ = 3 for the four kinds and q = 2 with m = 1 at τ = 4 for the
single-dominator ones; ``secure="off"`` unless stated.  JAX runs inside
module-scoped fixtures, once per case.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import algorithms, deep_vfl, engine, losses, staleness
from repro_torch.data import classification_dataset
from repro_torch.kernels import ops

N, D, BATCH, EPOCHS, HID, DREP, LR = 600, 32, 32, 2, 16, 8, 0.05
LAYOUTS = {"q4m2": (4, 2), "q2m1": (2, 1)}
TAUS = {"q4m2": 3, "q2m1": 4}
# kind -> (multi-dominator, pipelined)
KINDS = {"delayed": (False, False), "multi_delayed": (True, False),
         "pipelined_delayed": (False, True),
         "multi_pipelined_delayed": (True, True)}
FRESH = {"delayed": "deep_sgd_epoch", "multi_delayed": "deep_multi_sgd_epoch",
         "pipelined_delayed": "deep_pipelined_sgd_epoch",
         "multi_pipelined_delayed": "deep_multi_pipelined_sgd_epoch"}
CASES = [("q4m2", kind) for kind in KINDS] \
    + [("q2m1", kind) for kind in ("delayed", "pipelined_delayed")]
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


def _method(kind):
    multi, pipelined = KINDS[kind]
    return "deep_" + ("multi_" if multi else "") \
        + ("pipelined_" if pipelined else "") + "delayed_sgd_epoch"


def _rows(lid, kind):
    return (LAYOUTS[lid][1] if KINDS[kind][0] else 1) * BATCH


def _delays(lid, kind, tau=None, seed=0):
    layout = _layout(lid)
    tau = TAUS[lid] if tau is None else tau
    if KINDS[kind][0]:
        return torch.from_numpy(
            staleness.party_dominator_delays(layout, tau, seed)).long()
    return torch.from_numpy(
        staleness.party_delay_values(layout, tau, seed)).long()


def _leaves(p):
    return [np.asarray(a) for a in
            (*p.enc_w1, *p.enc_b1, *p.enc_w2, p.head)]


def _close_params(got, want, atol=1e-5):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _buffers(te, kind, pq, tau):
    return (te.deep_multi_delay_buffers if KINDS[kind][0]
            else te.deep_delay_buffers)(pq, tau)


def _drive(te, lid, kind, pq, idxs, tau=None, delays=None, key0=0):
    """The port engine's ``kind`` epochs from ``pq`` and zeroed rings over
    the schedules ``idxs``, the rings and the counter chained; returns
    ``(pq, bufq, t)``."""
    tau = TAUS[lid] if tau is None else tau
    delays = _delays(lid, kind, tau) if delays is None else delays
    fn = getattr(te, _method(kind))
    bufq, t = _buffers(te, kind, pq, tau), 0
    for ep, idx in enumerate(idxs):
        pq, bufq, t = fn(pq, bufq, t, delays, LR, idx, tau, (key0, ep))
    return pq, bufq, t


@pytest.fixture(scope="module")
def jx(ds):
    """The JAX package's runs, each made once per case: its init and
    schedules (the key stream its oracles and trainers draw), its oracles
    and its engine's chained epochs (``secure="off"``)."""
    import jax
    import jax.numpy as jnp
    from repro.core import algorithms as jalg
    from repro.core import deep_vfl as jdeep
    from repro.core import engine as jeng
    from repro.core import losses as jloss
    from repro.core import staleness as jst
    prob = jloss.logistic_l2()
    n = ds.y_train.shape[0]
    cache = {}

    def start(lid):
        if ("start", lid) not in cache:
            layout = jalg.PartyLayout.even(D, *LAYOUTS[lid])
            p0 = jdeep.init_deep_vfl(jax.random.PRNGKey(0), layout, D, HID,
                                     DREP)
            idxs = {}
            for rows in {BATCH, LAYOUTS[lid][1] * BATCH}:
                key, out = jax.random.PRNGKey(0), []
                for _ in range(EPOCHS):
                    key, sub = jax.random.split(key)
                    out.append((sub, np.array(jalg._batch_indices(
                        sub, n, rows, n // BATCH))))
                idxs[rows] = out
            cache["start", lid] = (layout, p0, idxs)
        return cache["start", lid]

    def engine_of(lid, kernel=False):
        if ("engine", lid, kernel) not in cache:
            cache["engine", lid, kernel] = jeng.FusedEngine(
                prob, ds.x_train, ds.y_train, start(lid)[0],
                jeng.EngineConfig(secure="off", use_kernel=kernel,
                                  interpret=True if kernel else None))
        return cache["engine", lid, kernel]

    def oracle(lid, kind):
        if ("oracle", lid, kind) not in cache:
            multi, pipelined = KINDS[kind]
            train = jst.train_deep_multi_delayed if multi \
                else jst.train_deep_delayed
            cache["oracle", lid, kind] = train(
                prob, ds.x_train, ds.y_train, start(lid)[0], TAUS[lid],
                epochs=EPOCHS, lr=LR, batch=BATCH, seed=0, hidden=HID,
                d_rep=DREP, pipelined=pipelined)
        return cache["oracle", lid, kind]

    def epochs(lid, kind):
        """The JAX engine's two chained epochs: (params, rings, counter)."""
        if ("epochs", lid, kind) not in cache:
            eng = engine_of(lid)
            _, p0, idxs = start(lid)
            multi, _ = KINDS[kind]
            tau = TAUS[lid]
            pq = eng.pack_deep(p0)
            bufq = (eng.deep_multi_delay_buffers if multi
                    else eng.deep_delay_buffers)(pq, tau)
            delays = jnp.asarray(_delays(lid, kind).numpy().astype(np.int32))
            t = jnp.zeros((), jnp.int32)
            fn = getattr(eng, _method(kind))
            for sub, _ in idxs[_rows(lid, kind)]:
                pq, bufq, t = fn(pq, bufq, t, delays, LR, sub, BATCH,
                                 n // BATCH, tau)
            cache["epochs", lid, kind] = (
                eng.unpack_deep(pq), [np.asarray(b) for b in bufq], int(t))
        return cache["epochs", lid, kind]

    return types.SimpleNamespace(jnp=jnp, start=start, engine=engine_of,
                                 oracle=oracle, epochs=epochs)


@pytest.fixture(scope="module")
def port(ds, prob, jx):
    """The port's engines (per layout, secure mode and ``active_only``),
    its oracle and its engine epochs from the reference's init on the
    reference's schedules, each made once."""
    cache = {}

    def engine_of(lid, secure="off", active_only=False):
        k = ("engine", lid, secure, active_only)
        if k not in cache:
            cache[k] = engine.FusedEngine(
                prob, ds.x_train, ds.y_train, _layout(lid),
                engine.EngineConfig(secure=secure), active_only=active_only,
                device="cpu")
        return cache[k]

    def start(lid, kind):
        _, p0, idxs = jx.start(lid)
        return (convert.deep_params(p0, device="cpu"),
                [torch.from_numpy(i) for _, i in idxs[_rows(lid, kind)]])

    def oracle(lid, kind, **kw):
        k = ("oracle", lid, kind, tuple(sorted(kw.items())))
        if k not in cache:
            multi, pipelined = KINDS[kind]
            train = staleness.train_deep_multi_delayed if multi \
                else staleness.train_deep_delayed
            p0, idxs = start(lid, kind)
            cache[k] = train(prob, ds.x_train, ds.y_train, _layout(lid),
                             TAUS[lid], epochs=EPOCHS, lr=LR, batch=BATCH,
                             hidden=HID, d_rep=DREP, pipelined=pipelined,
                             params=p0, indices=idxs, device="cpu", **kw)
        return cache[k]

    def epochs(lid, kind, secure="off", active_only=False):
        k = ("epochs", lid, kind, secure, active_only)
        if k not in cache:
            te = engine_of(lid, secure, active_only)
            p0, idxs = start(lid, kind)
            cache[k] = _drive(te, lid, kind, te.pack_deep(p0), idxs)
        return cache[k]

    return types.SimpleNamespace(engine=engine_of, start=start,
                                 oracle=oracle, epochs=epochs)


# ---------------------------------------------------------------------------
# the sequential oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lid,kind", CASES, ids=IDS)
def test_oracle_matches_jax(jx, port, lid, kind):
    state, hist = port.oracle(lid, kind)
    _close_params(state.params, jx.oracle(lid, kind))
    assert int(state.t) == EPOCHS * (port.engine(lid).n // BATCH)
    assert len(hist) == EPOCHS and all(np.isfinite(hist))


def test_oracle_options(ds, prob):
    layout = _layout("q4m2")
    with pytest.raises(ValueError, match="schedules"):
        staleness.train_deep_delayed(prob, ds.x_train, ds.y_train, layout,
                                     3, epochs=2,
                                     indices=[np.zeros((3, BATCH))],
                                     device="cpu")
    for fn in (staleness.train_deep_delayed,
               staleness.train_deep_multi_delayed):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(prob, ds.x_train, ds.y_train, layout, 3, epochs=1)


# ---------------------------------------------------------------------------
# the engine's deep delayed epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lid,kind", CASES, ids=IDS)
def test_engine_epochs_match_jax_engine(jx, port, lid, kind):
    """Two chained epochs: the iterate, every slot of the three rings (the
    reference's layouts) and the counter."""
    want, want_rings, want_t = jx.epochs(lid, kind)
    te = port.engine(lid)
    pq, bufq, t = port.epochs(lid, kind)
    _close_params(te.unpack_deep(pq), want)
    for got, ring in zip(bufq, want_rings):
        assert tuple(got.shape) == ring.shape
        for s in range(TAUS[lid] + 1):
            np.testing.assert_allclose(got[:, s].numpy(), ring[:, s],
                                       atol=1e-5, rtol=0)
    assert t.dtype == torch.int64 and t.dim() == 0
    assert int(t) == want_t == EPOCHS * (te.n // BATCH)


@pytest.mark.parametrize("lid,kind", CASES, ids=IDS)
def test_engine_epochs_match_port_oracle(port, lid, kind):
    """The engine against the port's oracle: the iterate and every ring
    slot (the engine's padded party stack against the oracle's per-party
    rings)."""
    te = port.engine(lid)
    pq, bufq, t = port.epochs(lid, kind)
    state, _ = port.oracle(lid, kind)
    _close_params(te.unpack_deep(pq), state.params)
    multi, _ = KINDS[kind]
    for got, rings in zip(bufq, state.rings):    # no padding: dp = d_ℓ
        for p, want in enumerate(rings):
            # the engine's (τ+1, ..., m, K) is the oracle's (τ+1, m, ..., K)
            g = got[p].movedim(-2, 1) if multi else got[p]
            np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-5,
                                       rtol=0)
    assert int(t) == int(state.t)


def test_ring_shape_must_match_tau(port):
    te = port.engine("q4m2")
    p0, idxs = port.start("q4m2", "delayed")
    pq = te.pack_deep(p0)
    with pytest.raises(ValueError, match="tau=2 needs 3"):
        te.deep_delayed_sgd_epoch(pq, te.deep_delay_buffers(pq, 3), 0,
                                  _delays("q4m2", "delayed"), LR, idxs[0], 2)


@pytest.mark.parametrize("kind", list(KINDS))
def test_tau0_equals_fresh_epoch(port, kind):
    """With no delay the ring hands each step its own gradients back: the
    delayed epoch is its fresh counterpart, bit for bit with one
    dominator.  With m the fresh step forms xᵀ∂u and hᵀϑ_z over all m·B
    rows and adds m·λ∇g once, the delayed step sums the m slabs that each
    carry λ∇g, which rounds differently: within 4 float32 ulps of each
    leaf's scale."""
    te = port.engine("q4m2")
    p0, idxs = port.start("q4m2", kind)
    pq0 = te.pack_deep(p0)
    got, _, _ = _drive(te, "q4m2", kind, pq0, idxs, tau=0,
                       delays=_delays("q4m2", kind, tau=0))
    fresh = getattr(te, FRESH[kind])
    want = pq0
    for ep, idx in enumerate(idxs):
        want = fresh(want, LR, idx, (0, ep))
    if KINDS[kind][0]:
        eps = torch.finfo(torch.float32).eps
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=4 * eps * float(w.abs().max()))
        assert not all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", list(KINDS))
def test_delays_change_the_trajectory(port, kind):
    """The τ = 3 epochs differ from the fresh ones on the same schedules."""
    te = port.engine("q4m2")
    p0, idxs = port.start("q4m2", kind)
    want = te.pack_deep(p0)
    for ep, idx in enumerate(idxs):
        want = getattr(te, FRESH[kind])(want, LR, idx, (0, ep))
    got = port.epochs("q4m2", kind)[0]
    diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert diff > 1e-6, diff


@pytest.mark.parametrize("kind", ["delayed", "multi_delayed"])
def test_active_only_freezes_passive_encoders(port, kind):
    """``active_only`` matches the oracle's ``freeze_passive``: the passive
    encoders stay at their start while their rings keep aging, the active
    ones and the head train."""
    te = port.engine("q4m2", active_only=True)
    pq, bufq, _ = port.epochs("q4m2", kind, active_only=True)
    got = te.unpack_deep(pq)
    state, _ = port.oracle("q4m2", kind, freeze_passive=True)
    _close_params(got, state.params)
    p0, _ = port.start("q4m2", kind)
    q, m = LAYOUTS["q4m2"]
    for leaf, ring in zip(("enc_w1", "enc_b1", "enc_w2"), bufq):
        for p in range(m, q):
            np.testing.assert_array_equal(getattr(got, leaf)[p].numpy(),
                                          getattr(p0, leaf)[p].numpy())
            assert float(ring[p].abs().max()) > 0
        assert float((getattr(got, leaf)[0]
                      - getattr(p0, leaf)[0]).abs().max()) > 1e-6
    assert float((got.head - p0.head).abs().max()) > 1e-6


@pytest.mark.parametrize("secure", ["two_tree", "ring"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_secure_modes_are_lossless(port, kind, secure):
    """Algorithm 1's masks cancel: the iterate and the rings within 1e-5
    of the ``off`` run."""
    got = port.epochs("q4m2", kind, secure)
    want = port.epochs("q4m2", kind)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the per-dominator wide contractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["kernel", "segment"])
def test_wide_contractions_match_jax(jx, port, route):
    """``_bwd_doms_wide`` over per-party (xᵀ∂u) and shared (hᵀϑ_z)
    cotangents and ``_pipe_doms_wide`` (Mw = K beside Mθ = m·K) against
    the JAX engine's per-party calls, on its Pallas route (interpret mode)
    and its segment-einsum route; the port's kernel route (the plain
    version here) and ``engine._seg_contract`` give the same slabs."""
    q, m = LAYOUTS["q4m2"]
    je = jx.engine("q4m2", kernel=route == "kernel")
    te = port.engine("q4m2")
    rng = np.random.default_rng(11)
    rows, k = m * BATCH, HID
    x = rng.standard_normal((q, 2 * rows, te.dp)).astype(np.float32)
    du = rng.standard_normal((q, rows, k)).astype(np.float32)
    h = np.tanh(rng.standard_normal((q, rows, HID))).astype(np.float32)
    thz = rng.standard_normal((rows, DREP)).astype(np.float32)
    w = rng.standard_normal((q, te.dp, k)).astype(np.float32)
    xt, dut, ht, thzt, wt = map(torch.from_numpy, (x, du, h, thz, w))
    xb = xt[:, :rows]
    got_w1 = te._bwd_doms_wide(xb, dut, m, 1)
    got_w2 = te._bwd_doms_wide(ht, thzt, m, BATCH)
    z, got_pipe = te._pipe_doms_wide(xt, rows, wt, dut, m, 2)
    jnp = jx.jnp
    for p in range(q):
        want = je._bwd_doms_wide(jnp.asarray(x[p, :rows]), jnp.asarray(du[p]),
                                 m, 1)
        np.testing.assert_allclose(got_w1[p].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        want = je._bwd_doms_wide(jnp.asarray(h[p]), jnp.asarray(thz), m,
                                 BATCH)
        np.testing.assert_allclose(got_w2[p].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        wz, wg = je._pipe_doms_wide(jnp.asarray(x[p, :rows]),
                                    jnp.asarray(x[p, rows:]),
                                    jnp.asarray(w[p]), jnp.asarray(du[p]),
                                    m, 2)
        np.testing.assert_allclose(z[p].numpy(), np.asarray(wz), atol=1e-4,
                                   rtol=1e-5)
        np.testing.assert_allclose(got_pipe[p].numpy(), np.asarray(wg),
                                   atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(engine._seg_contract(xb, dut, m), got_w1,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(engine._seg_contract(ht, thzt, m) / BATCH,
                               got_w2, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# launches: the contractions each step makes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_step_contractions(port, monkeypatch, kind):
    """A fresh delayed step calls ``ops.vfl_grad`` 4 times: layer 1's and
    layer 2's forward, then hᵀϑ_z and xᵀ∂u (multi: over the block-diagonal
    per-dominator columns, Mθ = m·d_rep and m·hidden); a pipelined
    interior step exactly once, fused with ``split`` (multi: Mw = hidden
    beside Mθ = m·hidden), beside a forward prologue and a backward
    epilogue."""
    te = port.engine("q4m2")
    p0, idxs = port.start("q4m2", kind)
    idx = idxs[0]
    steps, rows = idx.shape[0], idx.shape[1]
    pq = te.pack_deep(p0)
    multi, pipelined = KINDS[kind]
    m = LAYOUTS["q4m2"][1] if multi else 1
    step_name = "_deep_pipe_step" if pipelined else "_deep_fresh_step"
    calls, per_step = [], []
    real_call, real_step = ops.vfl_grad, getattr(te, step_name)

    def counting_call(xb, w, theta=None, *args, **kw):
        cols = (None if w is None else w.shape[-1],
                None if theta is None else theta.shape[-1])
        calls.append((kw.get("mode", "forward"), kw.get("split"), cols))
        return real_call(xb, w, theta, *args, **kw)

    def counting_step(*args):
        n0 = len(calls)
        real_step(*args)
        per_step.append(calls[n0:])

    monkeypatch.setattr(ops, "vfl_grad", counting_call)
    monkeypatch.setattr(te, step_name, counting_step)
    getattr(te, _method(kind))(pq, _buffers(te, kind, pq, 3), 0,
                               _delays("q4m2", kind), LR, idx, 3)
    fwd1, fwd2 = ("forward", None, (HID, None)), ("forward", None,
                                                  (DREP, None))
    bwd1 = ("backward", None, (None, m * HID))
    if pipelined:
        fused = ("fused", rows, (HID, m * HID))
        assert per_step == [[fused]] * (steps - 1)
        assert calls == [fwd1] + [fused] * (steps - 1) + [bwd1]
    else:
        bwd2 = ("backward", None, (None, m * DREP))
        assert per_step == [[fwd1, fwd2, bwd2, bwd1]] * steps


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_runners_match_port_oracle(ds, prob, multi, pipelined):
    """The runners from ``initial_params(seed)`` over ``epoch_indices``
    schedules, the rings and the counter carried across epochs, against
    the port's oracle on its default start and schedules."""
    layout, seed, tau = _layout("q4m2"), 4, 3
    run = staleness.run_deep_multi_delayed_fused if multi \
        else staleness.run_deep_delayed_fused
    train = staleness.train_deep_multi_delayed if multi \
        else staleness.train_deep_delayed
    kw = dict(epochs=EPOCHS, lr=LR, batch=BATCH, seed=seed, hidden=HID,
              d_rep=DREP, pipelined=pipelined, device="cpu")
    got = run(prob, ds.x_train, ds.y_train, layout, tau, **kw)
    want, _ = train(prob, ds.x_train, ds.y_train, layout, tau, **kw)
    _close_params(got, want.params)
    with pytest.raises(RuntimeError, match="cuda"):
        run(prob, ds.x_train, ds.y_train, layout, tau, epochs=1, lr=LR,
            batch=BATCH)


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
def test_cuda_deep_delayed_epochs_match_cpu_without_a_sync(cuda_device, ds,
                                                           prob, kind):
    """On the card each deep delayed epoch is an eager step (pipelined:
    prologue and epilogue) and replays of one captured step, run under
    ``set_sync_debug_mode("error")``: a captured fresh step launches the
    wide forward twice and the rows backward twice, a pipelined one
    ``vfl_fused_split`` once; the ring slot moves between replays (the
    rings and the counter equal the CPU engine's within 1e-5), and a
    second run replays the first bit for bit."""
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
    delays = _delays("q4m2", kind)
    dg = delays.to(cuda_device)
    p0 = deep_vfl.initial_params(0, layout, D, HID, DREP)
    pq0, pqg = ec.pack_deep(p0), eg.pack_deep(p0)
    for _ in range(2):                    # capture, then reuse the graph
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = _drive(eg, "q4m2", kind, pqg, idgs, delays=dg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    (loop,) = eg._loops.values()
    assert loop.per_step == ({"vfl_fused_split": 1} if KINDS[kind][1]
                             else {"vfl_forward_wide": 2,
                                   "vfl_backward_rows": 2})
    again = _drive(eg, "q4m2", kind, pqg, idgs, delays=dg)
    assert all(torch.equal(a, b) for a, b in
               zip(got[0] + got[1], again[0] + again[1]))
    want = _drive(ec, "q4m2", kind, pq0, idxs, delays=delays)
    for g, c in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=0)
    assert int(got[2]) == int(want[2]) == EPOCHS * (ec.n // BATCH)
