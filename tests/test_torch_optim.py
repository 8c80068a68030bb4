"""The port's optimisers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) over several steps, from the same numpy trees.

Tolerances, with their reasons:

* AdamW: 1e-6 of the parameters' scale after 6 steps.  Both compute the
  same f32 expression in the same order; only ``b ** t`` (a library
  ``pow``) and XLA's fusion may round differently, and Adam's step is
  m̂/(√n̂ + ε), so a few f32 ulps of the moments reach the parameters
  scaled by lr.
* The delayed optimiser and SVRG: 1e-6 (f32 sums and products of the same
  values in the same order: equal in practice).
* The per-leaf delays: equal (integers from the same md5 of the same key
  path strings).

The ports of the reference's own optimiser tests
(``tests/test_optim_ckpt.py:21-78``) keep its thresholds.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_arch
from repro_torch.models import model as tm
from repro_torch.optim import (adamw_init, adamw_update, delayed_init,
                               delayed_update, svrg_direction, svrg_snapshot)
from repro_torch.optim.delayed import _leaf_delay, leaf_delays
from repro_torch.optim.tree import leaves_with_path, tree_map

STEPS = 6


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro import optim
    from repro.optim import delayed, svrg
    return dict(jax=jax, jnp=jnp, optim=optim, delayed=delayed, svrg=svrg)


def _tree(seed):
    """A nested tree with a 0-d leaf, a vector, matrices and a stacked
    leaf (as the LM trees have)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": f(16, 4), "final_norm": f(4), "scale": f(),
            "stack": {"ssm": {"w_in": f(2, 4, 8), "a_log": f(2, 8, 3)},
                      "norm1": f(2, 4)}}


def _grads(seed, steps):
    return [_tree(seed + 100 + i) for i in range(steps)]


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(jx, tree):
    return jx["jax"].tree.map(jx["jnp"].asarray, tree)


def _assert_trees(got, want, atol):
    gl = leaves_with_path(got)
    wl = leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg=path)


def test_adamw_matches_jax(jx):
    p0, grads = _tree(0), _grads(0, STEPS)
    jp, jst = _j(jx, p0), None
    jst = jx["optim"].adamw_init(jp)
    tp = _t(p0)
    tst = adamw_init(tp)
    assert tst["step"].dtype == torch.int32 and tst["step"].dim() == 0
    for g in grads:
        jp, jst = jx["optim"].adamw_update(jp, _j(jx, g), jst, lr=1e-2)
        tp, tst = adamw_update(tp, _t(g), tst, lr=1e-2)
    _assert_trees(tp, jp, 1e-6)
    _assert_trees(tst["mu"], jst["mu"], 1e-6)
    _assert_trees(tst["nu"], jst["nu"], 1e-6)
    assert int(tst["step"]) == int(jst["step"]) == STEPS


@pytest.mark.parametrize("tau", [0, 3, 4])
def test_delayed_matches_jax(jx, tau):
    p0, grads = _tree(1), _grads(1, STEPS + tau)
    jp = _j(jx, p0)
    jst = jx["optim"].delayed_init(jp, tau)
    tp = _t(p0)
    tst = delayed_init(tp, tau)
    for g in grads:
        jp, jst = jx["optim"].delayed_update(jp, _j(jx, g), jst, lr=0.1)
        tp, tst = delayed_update(tp, _t(g), tst, lr=0.1)
    _assert_trees(tp, jp, 1e-6)
    _assert_trees(tst["buf"], jst["buf"], 1e-6)
    assert int(tst["step"]) == int(jst["step"]) == len(grads)
    assert tst["tau"] == tau


def test_svrg_matches_jax(jx):
    p0, (ref, now, snap) = _tree(2), _grads(2, 3)
    jsnap = jx["svrg"].svrg_snapshot(_j(jx, p0), _j(jx, ref))
    tp = _t(p0)
    tsnap = svrg_snapshot(tp, _t(ref))
    _assert_trees(tsnap["w_snap"], jsnap["w_snap"], 0)
    assert all(a.data_ptr() != b.data_ptr() for (_, a), (_, b) in zip(
        leaves_with_path(tsnap["w_snap"]), leaves_with_path(tp)))
    want = jx["svrg"].svrg_direction(_j(jx, now), _j(jx, snap), jsnap)
    got = svrg_direction(_t(now), _t(snap), tsnap)
    _assert_trees(got, want, 1e-6)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "gemma3_4b",
                                  "stablelm_1_6b"])
@pytest.mark.parametrize("tau", [3, 4])
def test_leaf_delays_match_jax_keystr(jx, arch, tau):
    """The delay of every leaf of a reduced LM tree: the port's key path
    strings are ``jax.tree_util.keystr``'s, so md5 gives each leaf the
    reference's delay."""
    jax = jx["jax"]
    cfg = get_arch(arch).reduced()
    params = tm.init_params(cfg, 0, device="cpu")
    jtree = tree_map(lambda a: np.zeros((1,), np.float32), params)
    want = {jax.tree_util.keystr(kp): jx["delayed"]._leaf_delay(
        jax.tree_util.keystr(kp), tau)
        for kp, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = leaf_delays(params, tau)
    assert list(got) == list(want)
    assert got == want
    assert "['stack']['norm1']" in got and "['embed']" in got
    # the rule itself, on one path
    path = "['embed']"
    assert _leaf_delay(path, tau) == int(
        hashlib.md5(path.encode()).hexdigest()[:8], 16) % (tau + 1)


# ---------------------------------------------------------------------------
# the reference's optimiser tests (tests/test_optim_ckpt.py:21-78), ported
# ---------------------------------------------------------------------------

def _quad_params():
    return {"a": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}


def _quad_grad(p):
    flat = {k: v.detach().requires_grad_() for k, v in p.items()}
    loss = torch.sum(flat["a"] ** 2) + flat["b"] ** 2
    ga, gb = torch.autograd.grad(loss, [flat["a"], flat["b"]])
    return {"a": ga, "b": gb}


def _quad_loss(p):
    return float(torch.sum(p["a"] ** 2) + p["b"] ** 2)


def test_adamw_decreases_quadratic():
    p = _quad_params()
    opt = adamw_init(p)
    l0 = _quad_loss(p)
    for _ in range(200):
        p, opt = adamw_update(p, _quad_grad(p), opt, lr=5e-2,
                              weight_decay=0.0)
    assert _quad_loss(p) < 0.05 * l0


def test_delayed_tau0_equals_sgd():
    p = _quad_params()
    st = delayed_init(p, tau=0)
    q = _quad_params()
    for _ in range(10):
        p, st = delayed_update(p, _quad_grad(p), st, lr=0.1)
        gq = _quad_grad(q)
        q = {k: q[k] - 0.1 * gq[k] for k in q}
    np.testing.assert_allclose(p["a"].numpy(), q["a"].numpy(), atol=1e-6)
    np.testing.assert_allclose(p["b"].numpy(), q["b"].numpy(), atol=1e-6)


def test_delayed_converges_with_stale_blocks():
    p = _quad_params()
    st = delayed_init(p, tau=3)
    l0 = _quad_loss(p)
    for _ in range(120):
        p, st = delayed_update(p, _quad_grad(p), st, lr=0.05)
    assert _quad_loss(p) < 0.05 * l0


def test_checkpoint_roundtrip(tmp_path):
    from repro_torch.checkpoint.ckpt import checkpoint_step
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree, step=7)
    out = load_checkpoint(path, tree_map(torch.zeros_like, tree))
    np.testing.assert_allclose(np.asarray(out["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(out["nested"]["b"]),
                                  tree["nested"]["b"].numpy())
    assert checkpoint_step(path) == 7


def test_svrg_direction_framework_scale():
    """v = g(w) − g(w̃) + μ̃ equals μ̃ exactly at the snapshot itself."""
    p = _quad_params()
    ref_grad = _quad_grad(p)
    snap = svrg_snapshot(p, ref_grad)
    v = svrg_direction(_quad_grad(p), _quad_grad(snap["w_snap"]), snap)
    np.testing.assert_allclose(v["a"].numpy(), ref_grad["a"].numpy())
    np.testing.assert_allclose(v["b"].numpy(), ref_grad["b"].numpy())
