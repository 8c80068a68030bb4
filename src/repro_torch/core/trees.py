"""Tree-structured communication (paper Algorithm 1 / Definition 4).

A reduction tree over parties {0..q-1} is described as a list of *rounds*;
each round is a list of (dst, src) pairs meaning "src sends its current
partial value to dst, dst accumulates".  This mirrors the paper's Fig. 5
binary aggregation trees and lets us (a) execute the schedule on the host
for the faithful reference, (b) replay the same schedule round by round as
index arithmetic over the party dimension of a party-stacked tensor
(``secure_agg.tree_psum_collective_permute``), and (c) statically check
Definition 4 ("significantly different" trees) before any value moves.

Pure Python: the same rounds as ``repro.core.trees``, kept as a copy so the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Sequence, Tuple

Round = List[Tuple[int, int]]  # (dst, src)


@dataclasses.dataclass(frozen=True)
class ReductionTree:
    """A binary-ish reduction schedule over ``q`` parties rooted at ``root``."""

    q: int
    root: int
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]

    def validate(self) -> None:
        alive = set(range(self.q))
        for rnd in self.rounds:
            dsts = [d for d, _ in rnd]
            srcs = [s for _, s in rnd]
            assert len(set(dsts + srcs)) == len(dsts + srcs), "party reused in round"
            for d, s in rnd:
                assert d in alive and s in alive, "dead party communicating"
            for s in srcs:
                alive.discard(s)
        assert alive == {self.root}, f"tree must reduce to root, got {alive}"

    # -- subtree structure (Definition 4) ---------------------------------
    def subtree_leafsets(self) -> List[FrozenSet[int]]:
        """Leaf sets of every internal subtree with size in (1, q)."""
        absorbed: Dict[int, set] = {p: {p} for p in range(self.q)}
        leafsets: List[FrozenSet[int]] = []
        for rnd in self.rounds:
            for d, s in rnd:
                absorbed[d] = absorbed[d] | absorbed[s]
                if 1 < len(absorbed[d]) < self.q:
                    leafsets.append(frozenset(absorbed[d]))
        return leafsets

    def reduce_host(self, values: Sequence):
        """Execute the schedule on host values (numbers or arrays)."""
        assert len(values) == self.q
        acc = list(values)
        for rnd in self.rounds:
            for d, s in rnd:
                acc[d] = acc[d] + acc[s]
        return acc[self.root]


def significantly_different(t1: ReductionTree, t2: ReductionTree) -> bool:
    """Definition 4: no shared proper subtree leaf-set of size in (1, q)."""
    return not (set(t1.subtree_leafsets()) & set(t2.subtree_leafsets()))


def binary_tree(q: int, order: Sequence[int] | None = None) -> ReductionTree:
    """Recursive-halving binary reduction over parties listed in ``order``.

    ``order`` permutes which physical party sits at which leaf — two trees
    built from suitably different orders satisfy Definition 4.
    """
    order = list(order if order is not None else range(q))
    assert sorted(order) == list(range(q))
    rounds: List[Round] = []
    stride = 1
    while stride < q:
        rnd: Round = []
        for i in range(0, q - stride, 2 * stride):
            rnd.append((order[i], order[i + stride]))
        rounds.append(rnd)
        stride *= 2
    t = ReductionTree(q=q, root=order[0], rounds=tuple(tuple(r) for r in rounds))
    t.validate()
    return t


def survivor_tree_pair(
    q: int, survivors: Sequence[int],
) -> Tuple[ReductionTree, ReductionTree, List[int]]:
    """Rebuild a Definition-4 (T1, T2) pair after a membership change.

    ``survivors`` are the original party ids still alive.  The returned
    trees live in the *compact* index space ``0..s-1``; the third element
    maps compact index → original party id (``surv[ci]``), which callers
    use to route values in and transcript entries back out.

    Raises ``ValueError`` when fewer than 3 parties survive: the two-tree
    structure is then degenerate (no pair of significantly different trees
    with proper subtrees exists), and callers must degrade to the
    pairwise-cancelling masked psum with an explicit warning
    (``secure_agg.secure_aggregate_survivors`` does).
    """
    surv = sorted(set(int(p) for p in survivors))
    if any(p < 0 or p >= q for p in surv):
        raise ValueError(f"survivor ids must be in [0, {q}); got {surv}")
    s = len(surv)
    if s < 3:
        raise ValueError(
            f"two-tree rebuild needs >= 3 survivors, got {s}; degrade to "
            "masked psum (secure_aggregate_survivors handles this)")
    t1, t2 = default_tree_pair(s)
    return t1, t2, surv


def default_tree_pair(q: int) -> Tuple[ReductionTree, ReductionTree]:
    """A (T1, T2) pair satisfying Definition 4 for q >= 2.

    T1 reduces neighbours (0,1)(2,3)...; T2 reduces a stride-permuted
    order so no intermediate aggregate of T1 re-appears in T2 (mirrors the
    paper's Fig. 5: (1,2)(3,4) vs (1,3)(2,4)).
    """
    t1 = binary_tree(q)
    if q == 2:
        # Only one tree shape exists for q=2; it has no proper subtrees of
        # size in (1, q) so any pair is vacuously "significantly different".
        return t1, binary_tree(q, order=[1, 0])
    # interleave even/odd parties => pairs (0,2)(1,3)... share no leafset
    order = list(range(0, q, 2)) + list(range(1, q, 2))
    t2 = binary_tree(q, order=order)
    if not significantly_different(t1, t2):  # pragma: no cover - q<=2 only
        raise ValueError(f"could not build Definition-4 pair for q={q}")
    return t1, t2
