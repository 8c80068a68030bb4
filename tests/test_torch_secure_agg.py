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


# ---------------------------------------------------------------------------
# host-side Algorithm 1 (secure_aggregate_host) and host_theta
# ---------------------------------------------------------------------------

def _host_pair(partials, seed, **kw):
    """The port's and the reference's (sum, transcript) from generators in
    the same state."""
    from repro.core import secure_agg as jagg
    out, tr = secure_agg.secure_aggregate_host(
        partials, np.random.default_rng(seed), **kw)
    if "t1" in kw:
        kw = dict(kw, t1=jtrees.ReductionTree(kw["t1"].q, kw["t1"].root,
                                              kw["t1"].rounds),
                  t2=jtrees.ReductionTree(kw["t2"].q, kw["t2"].root,
                                          kw["t2"].rounds))
    ref, rtr = jagg.secure_aggregate_host(
        partials, np.random.default_rng(seed), **kw)
    return out, tr, ref, rtr


@pytest.mark.parametrize("shape", [(3,), (2, 4)])
@pytest.mark.parametrize("q", [2, 3, 5, 8, 13])
def test_host_aggregate_matches_reference_bit_for_bit(q, shape):
    rng = np.random.default_rng(q)
    partials = [rng.standard_normal(shape) for _ in range(q)]
    out, tr, ref, rtr = _host_pair(partials, 100 + q, mask_scale=3.0)
    assert out.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, np.sum(partials, axis=0), atol=1e-8)
    assert [[tag for tag, _ in m] for m in tr.messages] == \
        [[tag for tag, _ in m] for m in rtr.messages]
    for p in range(q):
        for a, b in zip(tr.seen_by(p), rtr.seen_by(p)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [3, 4, 7, 12])
def test_host_aggregate_transmits_no_partial(q):
    """Threat model 1: every value a party receives differs from every
    other party's raw partial (own values never transit)."""
    rng = np.random.default_rng(q + 1)
    partials = [rng.standard_normal(4) for _ in range(q)]
    out, tr = secure_agg.secure_aggregate_host(partials, rng)
    np.testing.assert_allclose(out, np.sum(partials, axis=0), atol=1e-8)
    raw = np.stack(partials)
    assert sum(len(tr.seen_by(p)) for p in range(q)) == 2 * (q - 1)
    for p in range(q):
        for seen in tr.seen_by(p):
            diffs = np.abs(raw - seen[None]).min(axis=1)
            assert all(diffs[o] > 1e-9 for o in range(q) if o != p)


def test_host_aggregate_shared_subtree_leaks_a_partial():
    """Supplementary B: with T2 = T1 (Definition 4 violated) party 2
    receives p3 + δ3 over T1 and δ3 over T2, and so recovers p3."""
    t1 = trees.binary_tree(4)
    assert not trees.significantly_different(t1, t1)
    partials = list(np.random.default_rng(0).standard_normal((4, 1)))
    _, tr, _, rtr = _host_pair(partials, 0, t1=t1, t2=t1)
    masked_p3, delta3 = tr.seen_by(2)[:2]
    np.testing.assert_allclose(masked_p3 - delta3, partials[3])
    np.testing.assert_array_equal(rtr.seen_by(2)[0], masked_p3)


def test_host_aggregate_definition4_pair_hides_every_partial():
    """With the Definition-4 pair no difference of two values one party
    received equals another party's raw partial."""
    q = 8
    t1, t2 = trees.default_tree_pair(q)
    rng = np.random.default_rng(1)
    partials = [rng.standard_normal(1) for _ in range(q)]
    _, tr = secure_agg.secure_aggregate_host(partials, rng, t1=t1, t2=t2)
    raw = np.concatenate(partials)
    for p in range(q):
        seen = tr.seen_by(p)
        for i in range(len(seen)):
            for j in range(len(seen)):
                if i != j:
                    diff = seen[i] - seen[j]
                    assert not any(np.allclose(diff, raw[o], atol=1e-9)
                                   for o in range(q) if o != p)


def test_host_theta_matches_reference():
    import jax.numpy as jnp

    from repro.core import bum as jbum
    from repro.core import losses as jloss
    from repro_torch.core import bum, losses
    rng = np.random.default_rng(5)
    agg = rng.standard_normal(16).astype(np.float32)
    y = np.sign(rng.standard_normal(16)).astype(np.float32)
    for name in ("logistic_l2", "ridge", "robust_regression"):
        got = bum.host_theta(losses.PROBLEMS[name]().theta,
                             torch.from_numpy(agg), torch.from_numpy(y))
        want = jbum.host_theta(getattr(jloss, name)().theta,
                               jnp.asarray(agg), jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-7, rtol=1e-6)
