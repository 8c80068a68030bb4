"""Known-bad aggregation mutants: the analyzer's self-test.

The counterpart of ``repro.analysis.mutants``.  A linter that never fires
is worse than none, so the lint run opens by analysing deliberately
broken aggregations (each a realistic way to get Algorithm 1 wrong) and
shipped-secure controls, each a torch function on a party-stacked (q, 8)
partial with q = 4 that calls the port's ``core.secure_agg`` forms.  The
gate: every mutant gives its named finding and every control is clean —
otherwise the analyzer is broken and the matrix means nothing.

* ``off_psum`` — the partials summed over the party axis unmasked →
  ``unmasked-boundary``;
* ``equal_seeded`` — the two-tree form with one draw expanded over q:
  every party adds the same δ → ``mask-not-party-distinct``;
* ``no_rekey`` — per-party ring masks from one draw that feeds the
  aggregations of two membership sets → ``mask-feeds-two-aggregations``
  (the port's membership rule, checked under ``membership=True`` as the
  faulted entries are; the reference's ``mask-not-membership-keyed``);
* ``control_two_tree`` — the shipped ``secure_psum``: clean;
* ``control_ring_members`` — the shipped ``secure_psum_ring_members``
  (membership rule on): clean;
* ``hier_inner_only`` — the two-level form (2 slots × 2 parties a slot)
  whose masks are drawn per inner position and repeated over the slots →
  ``mask-not-party-distinct`` under the two-level boundary rule;
* ``control_hier`` — the shipped ``secure_psum_hier``: clean.

On a device mesh (:func:`run_dist_selftest`, every rank of a flat world
of Q ranks calling), each a rank's (1, 8) partial through the port's
``*_dist`` forms over the model group:

* ``dist_off_psum`` — an unmasked model-group ``all_reduce`` →
  ``unmasked-boundary``;
* ``dist_same_seed`` — the seed check (``taint.seed_findings``) over the
  ranks' streams, rank 1's own stream seeded as rank 0's →
  ``mask-not-party-distinct``;
* ``dist_counter_unmasked`` — the ring's membership form with its
  counter mask dropped → ``unmasked-boundary``;
* ``dist_broadcast_partial`` — slot 0 broadcasts its raw partial, not a
  tagged answer → ``unmasked-boundary``;
* ``dist_prev_only`` — a partial masked by the ring's ``prev`` stream
  alone (the rank before's own, which that rank can remove) →
  ``mask-not-party-distinct`` under the collective rule;
* ``control_dist_two_tree`` (``secure_psum_dist``),
  ``control_dist_ring_members`` (``secure_psum_ring_members_dist``, the
  counter stream, membership rule on), ``control_dist_tree_sf`` (the
  send/recv tree replay; on the CPU only: gloo refuses a CUDA tensor's
  send) and ``control_dist_seeds`` (the streams as seeded): clean.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.analysis.taint import (EQUAL_SEEDED, MASK_REUSED, UNMASKED,
                                        analyze_program, finding_codes,
                                        seed_findings)
from repro_torch.core import secure_agg
from repro_torch.core.engine import trace_program

Q = 4
WIDTH = 8
SLOTS, PPS = 2, 2


def _draw(gen, *shape):
    return secure_agg._party_normal(shape, gen, "cpu")


def off_psum(z, gen):
    """Mutant: unmasked reduction over the party axis."""
    return z.sum(0)


def equal_seeded(z, gen):
    """Mutant: two-tree masking with one draw shared by every party."""
    delta = _draw(gen, z.shape[1]).expand_as(z)          # not per party!
    return (z + delta).sum(0) - delta.sum(0)


def no_rekey(z, gen, alive, alive2):
    """Mutant: per-party ring masks drawn once, feeding the survivor sums
    of two membership sets."""
    r = _draw(gen, *z.shape)
    masked = z + (r - torch.roll(r, 1, dims=0))
    return (alive[:, None] * masked).sum(0), (alive2[:, None] * masked).sum(0)


def control_two_tree(z, gen):
    """Positive control: the shipped two-tree masked reduction."""
    return secure_agg.secure_psum(z, gen)


def control_ring_members(z, gen, alive):
    """Positive control: the shipped membership-aware ring reduction."""
    return secure_agg.secure_psum_ring_members(z, gen, alive)


def hier_inner_only(z, gen):
    """Mutant: the two-level aggregation with masks drawn per inner
    position and repeated over the slots, at both levels."""
    inner = secure_agg._inner_major(z, SLOTS)             # (pps, slots, 8)
    d1 = _draw(gen, PPS, 1, z.shape[1]).expand_as(inner)
    z_slot = (inner + d1).sum(0) - d1.sum(0)              # (slots, 8)
    d2 = _draw(gen, z.shape[1]).expand_as(z_slot)
    return (z_slot + d2).sum(0) - d2.sum(0)


def control_hier(z, gen):
    """Positive control: the shipped two-level masked reduction."""
    return secure_agg.secure_psum_hier(z, gen, SLOTS)


def trace(fn, **extra):
    """``fn(z, gen, **extra)`` traced over a zero (Q, WIDTH) partial ``z``
    (the taint source, party dim 0) and (Q,) alive flags (party dim 0)."""
    gen = torch.Generator().manual_seed(0)
    inputs = {"z": torch.zeros((Q, WIDTH)), **extra}
    return trace_program(lambda b: fn(b["z"], gen, *(b[k] for k in extra)),
                         inputs, dict.fromkeys(inputs, 0))


@dataclasses.dataclass
class MutantResult:
    name: str
    expected: Dict[str, int]   # required finding codes (empty = clean)
    actual: Dict[str, int]

    @property
    def ok(self) -> bool:
        if not self.expected:
            return not self.actual
        return all(self.actual.get(code, 0) >= n
                   for code, n in self.expected.items())

    def to_dict(self) -> dict:
        return {"expected": dict(self.expected),
                "actual": dict(self.actual), "ok": self.ok}


def _dist_cases(pm, device):
    """The device-mesh mutants and controls: (name, traced program,
    membership, expected codes)."""
    import torch.distributed as dist
    grp = pm.model_group
    streams = secure_agg.PartyStreams(pm.parties, pm.slot, pm.q, pm.slots,
                                      True, device).seed(0)

    def off_psum(b):
        return secure_agg.psum_dist(b["z"][0], grp)

    def counter_unmasked(b):
        # secure_psum_ring_members_dist with its counter mask dropped
        alive_all = secure_agg.gather_flags_dist(b["alive"], grp)
        me = dist.get_group_rank(grp, dist.get_rank())
        return secure_agg.psum_dist(alive_all[me] * b["z"][0], grp)

    def prev_only(b):
        # masked by the ring's prev stream alone: the rank before's own
        z = b["z"][0]
        return secure_agg.psum_dist(
            z + secure_agg._normal(z.shape, streams.prev, z.device), grp)

    def broadcast_partial(b):
        out = b["z"][0].clone()
        dist.broadcast(out, dist.get_global_rank(grp, 0), group=grp)
        return out

    def two_tree(b):
        return secure_agg.secure_psum_dist(b["z"][0], streams.own[0], grp)

    def ring_members(b):
        return secure_agg.secure_psum_ring_members_dist(
            b["z"][0], b["key"], secure_agg.gather_flags_dist(b["alive"],
                                                              grp), grp)

    def tree_sf(b):
        return secure_agg.secure_psum_dist(b["z"][0], streams.own[0], grp,
                                           schedule_faithful=True)

    inputs = {"z": torch.zeros((pm.parties_per_slot, WIDTH), device=device),
              "alive": torch.ones(pm.parties_per_slot, device=device),
              "key": torch.zeros(3, dtype=torch.int64, device=device)}
    dims = {"z": 0, "alive": 0, "key": None}
    cases = [("dist_off_psum", off_psum, False, {UNMASKED: 1}),
             ("dist_counter_unmasked", counter_unmasked, True,
              {UNMASKED: 1}),
             ("dist_broadcast_partial", broadcast_partial, False,
              {UNMASKED: 1}),
             ("dist_prev_only", prev_only, False, {EQUAL_SEEDED: 1}),
             ("control_dist_two_tree", two_tree, False, {}),
             ("control_dist_ring_members", ring_members, True, {})]
    if torch.device(device).type == "cpu":
        cases.append(("control_dist_tree_sf", tree_sf, False, {}))
    return [(name, trace_program(fn, inputs, dims), membership, expected)
            for name, fn, membership, expected in cases]


def _dist_seed_cases(pm, device) -> List[MutantResult]:
    """The seed check over every rank's ring streams as seeded, and with
    rank 1's own stream seeded as rank 0's."""
    import torch.distributed as dist
    out = []
    for name, same in (("control_dist_seeds", False),
                       ("dist_same_seed", True)):
        streams = secure_agg.PartyStreams(pm.parties, pm.slot, pm.q,
                                          pm.slots, True, device).seed(0)
        if same and pm.slot == 1:       # party 0's own seed
            secure_agg.seed_generator(streams.own[0], 0,
                                      secure_agg._L1_SALT, 0)
        tables = [None] * dist.get_world_size()
        dist.all_gather_object(tables, (pm.data_index, streams.seeds()))
        out.append(MutantResult(name, {EQUAL_SEEDED: 1} if same else {},
                                finding_codes(seed_findings(tables))))
    return out


def run_dist_selftest(pm, device="cuda") -> List[MutantResult]:
    """The device-mesh mutants and controls on ``pm`` (a flat
    ``PartyMesh`` on a device mesh; every rank calls); see the module
    docstring.  Each rank analyses its own traces."""
    return [MutantResult(name, expected, finding_codes(analyze_program(
                gm, membership, sources=("z",))))
            for name, gm, membership, expected in _dist_cases(pm, device)] \
        + _dist_seed_cases(pm, device)


def run_selftest() -> List[MutantResult]:
    """Analyse every mutant and control; see the module docstring."""
    alive = torch.ones(Q)
    cases = [
        ("off_psum", trace(off_psum), False, {UNMASKED: 1}),
        ("equal_seeded", trace(equal_seeded), False, {EQUAL_SEEDED: 1}),
        ("no_rekey", trace(no_rekey, alive=alive, alive2=alive), True,
         {MASK_REUSED: 1}),
        ("control_two_tree", trace(control_two_tree), False, {}),
        ("control_ring_members", trace(control_ring_members, alive=alive),
         True, {}),
        ("hier_inner_only", trace(hier_inner_only), False, {EQUAL_SEEDED: 1}),
        ("control_hier", trace(control_hier), False, {}),
    ]
    return [MutantResult(name, expected, finding_codes(analyze_program(
                gm, membership, sources=("z",))))
            for name, gm, membership, expected in cases]
