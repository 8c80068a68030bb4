"""The port's trees and Algorithm-1 aggregation against the JAX package.

* the ported reduction trees have the reference's rounds, roots and
  Definition-4 verdicts;
* ``secure_psum`` (both ``schedule_faithful`` settings) and
  ``secure_psum_ring`` equal the plain party sum at 1e-5, and the JAX
  ``secure_psum`` under ``vmap`` at 1e-5 (masks differ, so the two agree
  to the mask residue, not bit for bit);
* every transmitted value differs from the party's raw partial, and the
  masks are per-party distinct.
"""
import numpy as np
import pytest
import torch

from repro.core import trees as jtrees
from repro_torch.core import secure_agg, trees

QS = [2, 3, 4, 6, 8, 100]
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q", QS)
def test_tree_pair_matches_reference(q):
    t1, t2 = trees.default_tree_pair(q)
    r1, r2 = jtrees.default_tree_pair(q)
    assert (t1.root, t1.rounds) == (r1.root, r1.rounds)
    assert (t2.root, t2.rounds) == (r2.root, r2.rounds)
    assert trees.significantly_different(t1, t2)
    assert sorted(t1.subtree_leafsets(), key=sorted) == \
        sorted(r1.subtree_leafsets(), key=sorted)


def test_survivor_pair_and_definition4_match_reference():
    t1, t2, surv = trees.survivor_tree_pair(6, [0, 2, 3, 5])
    r1, r2, rsurv = jtrees.survivor_tree_pair(6, [0, 2, 3, 5])
    assert (t1.rounds, t2.rounds, surv) == (r1.rounds, r2.rounds, rsurv)
    same = trees.binary_tree(4)
    assert not trees.significantly_different(same, same)
    with pytest.raises(ValueError, match=">= 3 survivors"):
        trees.survivor_tree_pair(4, [1, 2])


def _partials(q, shape, seed=0):
    a = np.random.default_rng(seed).standard_normal((q,) + shape)
    return torch.from_numpy(a.astype(np.float32))


@pytest.mark.parametrize("q", [2, 3, 4, 8])
def test_tree_replay_is_the_host_tree_sum(q):
    """Round-by-round replay equals the tree's own host reduction bit for
    bit, and every party ends up holding the root total."""
    x = _partials(q, (5,))
    for tree in trees.default_tree_pair(q):
        out = secure_agg.tree_psum_collective_permute(x, tree)
        host = tree.reduce_host(list(x))
        for p in range(q):
            assert torch.equal(out[p], host)


@pytest.mark.parametrize("shape", [(7,), (5, 3)])
@pytest.mark.parametrize("q", [2, 3, 4, 8])
@pytest.mark.parametrize("form", ["psum", "psum_faithful", "ring"])
def test_masked_sum_equals_plain_sum(form, q, shape):
    x = _partials(q, shape)
    gen = secure_agg.mask_generator(0, q, device="cpu")
    if form == "ring":
        out = secure_agg.secure_psum_ring(x, gen)
    else:
        out = secure_agg.secure_psum(
            x, gen, schedule_faithful=form == "psum_faithful")
    assert out.shape == shape and out.dtype == torch.float32
    torch.testing.assert_close(out, x.sum(0), **TOL)


@pytest.mark.parametrize("form", ["psum", "psum_faithful", "ring"])
def test_matches_jax_secure_psum(form):
    import jax

    from repro.core import secure_agg as jagg
    q = 6
    x = _partials(q, (9,), seed=3)

    def party(p):
        key = jax.random.PRNGKey(7)
        if form == "ring":
            return jagg.secure_psum_ring(p, "i", key)
        return jagg.secure_psum(p, "i", key, q=q,
                                schedule_faithful=form == "psum_faithful")

    ref = np.asarray(jax.vmap(party, axis_name="i")(x.numpy()))[0]
    gen = secure_agg.mask_generator(7, device="cpu")
    out = secure_agg.secure_psum_ring(x, gen) if form == "ring" else \
        secure_agg.secure_psum(x, gen,
                               schedule_faithful=form == "psum_faithful")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("form", ["psum", "ring"])
@pytest.mark.parametrize("q", [2, 4, 8])
def test_transmitted_values_are_masked_per_party(form, q):
    x = _partials(q, (16,))
    sent = []
    gen = secure_agg.mask_generator(1, device="cpu")
    if form == "ring":
        secure_agg.secure_psum_ring(x, gen, transcript=sent)
    else:
        secure_agg.secure_psum(x, gen, transcript=sent)
    (masked,) = sent
    masks = masked - x
    for p in range(q):
        assert not torch.allclose(masked[p], x[p], atol=1e-3), \
            f"party {p} sent its raw partial"
        for r in range(p + 1, q):
            assert not torch.allclose(masks[p], masks[r], atol=1e-3), \
                f"parties {p} and {r} share a mask"
    if form == "ring":      # pairwise-cancelling: the masks sum to zero
        torch.testing.assert_close(masks.sum(0), torch.zeros(16),
                                   atol=1e-5, rtol=0)


def test_mask_generator_streams():
    def draw(*key):
        gen = secure_agg.mask_generator(*key, device="cpu")
        return torch.randn(8, generator=gen)

    assert torch.equal(draw(0, 1, 2), draw(0, 1, 2))
    assert not torch.equal(draw(0, 1, 2), draw(0, 2, 1))
    assert not torch.equal(draw(0, 1, 2), draw(1, 1, 2))
