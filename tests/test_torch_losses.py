"""The port's four ``Problem``s against ``repro.core.losses``, elementwise.

Same f32 inputs (numpy, from a seed) through both; loss, ϑ, regularizer,
its gradient and the block objective agree at 1e-6 (f32 elementwise
transcendental functions of two libraries).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import losses

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(losses.PROBLEMS))
def test_problem_matches_reference(name):
    import jax.numpy as jnp

    from repro.core import losses as jlosses
    rng = np.random.default_rng(0)
    agg = (3.0 * rng.standard_normal(50)).astype(np.float32)
    y = np.where(rng.standard_normal(50) > 0, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal(9).astype(np.float32)
    xb = rng.standard_normal((50, 9)).astype(np.float32)
    p, r = losses.PROBLEMS[name](0.01), jlosses.PROBLEMS[name](0.01)
    assert (p.name, p.lam, p.strongly_convex) == \
        (r.name, r.lam, r.strongly_convex)
    ta, ty, tw, tx = (torch.from_numpy(a) for a in (agg, y, w, xb))
    ja, jy, jw, jx = (jnp.asarray(a) for a in (agg, y, w, xb))
    for fp, fr, args_t, args_j in (
            (p.loss, r.loss, (ta, ty), (ja, jy)),
            (p.theta, r.theta, (ta, ty), (ja, jy)),
            (p.reg, r.reg, (tw,), (jw,)),
            (p.reg_grad, r.reg_grad, (tw,), (jw,))):
        np.testing.assert_allclose(fp(*args_t).numpy(),
                                   np.asarray(fr(*args_j)), **TOL)
    blocks_t, blocks_j = (tw[:4], tw[4:]), (jw[:4], jw[4:])
    xs_t, xs_j = (tx[:, :4], tx[:, 4:]), (jx[:, :4], jx[:, 4:])
    np.testing.assert_allclose(float(p.objective(blocks_t, xs_t, ty)),
                               float(r.objective(blocks_j, xs_j, jy)),
                               rtol=1e-5)
    th = p.theta(ta, ty)
    np.testing.assert_allclose(
        p.block_grad(tw[:4], tx[:, :4], th, 50).numpy(),
        np.asarray(r.block_grad(jw[:4], jx[:, :4], jnp.asarray(th.numpy()),
                                50)), atol=1e-5, rtol=1e-5)
