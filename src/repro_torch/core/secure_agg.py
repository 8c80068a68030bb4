"""Secure aggregation (paper Algorithm 1) over a party-stacked tensor.

The port of ``repro.core.secure_agg``.  The q
parties are the leading dimension of ``partial`` (shape ``(q, ...)``), all
on one device — the single-device emulation the JAX engine runs under
``vmap``.  A ``psum`` over the party axis is ``.sum(0)``; a ``ppermute``
round of a reduction tree is ``acc[dst] += acc[src]`` on dimension 0.

* ``secure_psum`` — masked two-tree reduction: each party adds its own
  Gaussian mask δ_ℓ, the masked values are reduced (over T1 when
  ``schedule_faithful``), the masks over the significantly different T2,
  and the output is ξ1 − ξ2.
* ``secure_psum_ring`` — pairwise-cancelling ring masks
  δ_ℓ = r_ℓ − r_{ℓ−1}, Σ_ℓ δ_ℓ ≡ 0, one reduction.

Masks come from an explicit ``torch.Generator``; all q parties' masks are
drawn in one call, so they are per-party distinct.  The generator cannot
reproduce the JAX package's threefry bits, so port and reference agree to
float tolerance (the mask residue), not bit for bit.  Mask arithmetic is
f32 whatever the partial's dtype, as in the reference.

Each function returns the aggregate every party receives, without the
party dimension.  ``transcript``, when a list, receives the party-stacked
tensor of the values that cross the party boundary (for the security
tests: every transmitted value is mask-offset).

``secure_aggregate_host`` is the faithful host form of Algorithm 1: numpy
values, explicit masks drawn from a ``np.random.Generator``, explicit
tree schedules, and an ``AggTranscript`` of every message each party
receives.  For the same generator and trees it gives the reference's
numbers bit for bit.

The membership-aware forms (fault tolerance: party dropout and rejoin)
take an ``alive`` (q,) 0/1 vector beside the partials, a device tensor
that a captured step computes (from a fault trace's forward liveness, or
from a finiteness verdict), so every survivor-dependent quantity — rank
in the surviving sub-ring, survivor count, the mask gather — is a tensor
op with no host read.

* ``secure_psum_members`` — ξ₁ − ξ₂ with both sums over the survivors
  only;
* ``secure_psum_ring_members`` — ring masks by rank in the surviving
  sub-ring, Σδ ≡ 0 over the survivors for any survivor count;
* ``secure_aggregate_survivors`` — the host form: Algorithm 1 re-run over
  the survivors with a rebuilt Definition-4 tree pair, degrading below 3
  survivors to a pairwise-cancelling masked psum with a warning (or an
  error under ``strict``).

The two-level forms (``secure_psum_hier``, ``secure_psum_hier_members``)
run the flat forms within each slot of a packed ``PartyMesh``, then
across the slots' sums.

The ``*_dist`` forms run over a ``torch.distributed`` process group, one
member a slot of a device mesh (``PartyMesh(mesh=...)``): each member
holds its own partial and draws only its own logical parties' masks, from
the generators of a :class:`PartyStreams` seeded per party — the
counterpart of the reference's ``fold_in(key, axis_index)``.  A ``psum``
is an ``all_reduce``, a tree round a ``batch_isend_irecv`` of its pairs.
The ring's r_prev, the mask of the party before, comes from that party's
stream: the one stream a member holds that is not its own.

The ring's membership form over a process group
(``secure_psum_ring_members_dist``) picks a survivor's predecessor by the
survivors, a choice made on the device at every step, so its masks come
from a counter-based stream keyed by device data instead of a generator:
``_counter_normal``, Philox-4x32-10 in plain torch integer ops, keyed by
the step key, the fingerprint of the gathered alive vector and the
survivor's rank r.  A member draws exactly two rows of it, r and
(r − 1) mod n_alive (``_ring_member_mask``), the reference's
``fold_in(fold_in(key, fingerprint), rank)``.

Re-keying: the reference folds the alive-set fingerprint
(``_alive_fingerprint``) into the step's threefry key, so that no mask
stream of one membership set is reused under another.  The port cannot
re-seed a generator from device data inside a captured step; instead
every aggregation draws its masks fresh from the step's generator, so one
step's masks serve exactly one membership set and no draw is ever used
twice.  The counter stream re-keys on membership as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from repro_torch.core import trees as trees_lib


@dataclasses.dataclass
class AggTranscript:
    """Every value each party observed during the protocol (for audits)."""

    # messages[p] = list of (tag, value) pairs party p received
    messages: List[List[Tuple[str, np.ndarray]]]

    def seen_by(self, party: int) -> List[np.ndarray]:
        return [v for _, v in self.messages[party]]


def secure_aggregate_host(
    partials: Sequence[np.ndarray],
    rng: np.random.Generator,
    t1: Optional[trees_lib.ReductionTree] = None,
    t2: Optional[trees_lib.ReductionTree] = None,
    mask_scale: float = 1.0,
) -> Tuple[np.ndarray, AggTranscript]:
    """Algorithm 1 on host values; returns (sum, transcript).

    ``partials[ℓ]`` is party ℓ's local ``w_{G_ℓ}ᵀ(x_i)_{G_ℓ}`` (any shape).
    Each party masks its partial with δ_ℓ ~ N(0, mask_scale²), the masked
    values are reduced over T1 and the masks over T2, and the output is
    ξ1 − ξ2.  Without trees, ``trees.default_tree_pair(q)``; explicit
    trees may violate Definition 4, to study the collusion attack."""
    q = len(partials)
    if t1 is None or t2 is None:
        t1, t2 = trees_lib.default_tree_pair(q)   # checks Definition 4
    partials = [np.asarray(p, dtype=np.float64) for p in partials]
    deltas = [mask_scale * rng.standard_normal(partials[0].shape)
              for _ in range(q)]
    masked = [p + d for p, d in zip(partials, deltas)]
    transcript = AggTranscript(messages=[[] for _ in range(q)])

    def run(tree: trees_lib.ReductionTree, values, tag: str):
        acc = list(values)
        for rnd in tree.rounds:
            for dst, src in rnd:
                transcript.messages[dst].append((f"{tag}:from{src}",
                                                 acc[src].copy()))
                acc[dst] = acc[dst] + acc[src]
        return acc[tree.root]

    xi1 = run(t1, masked, "xi1")   # masked sum over T1
    xi2 = run(t2, deltas, "xi2")   # mask sum over the different T2
    return xi1 - xi2, transcript


def secure_aggregate_survivors(
    partials: Sequence[np.ndarray],
    alive: Sequence[bool],
    rng: np.random.Generator,
    mask_scale: float = 1.0,
    strict: bool = False,
) -> Tuple[np.ndarray, AggTranscript]:
    """Algorithm 1 across a membership change (host form).

    The protocol is re-run over the survivors only: (T1, T2) are rebuilt
    over them (``trees.survivor_tree_pair``, Definition 4 kept), fresh
    masks are drawn (no mask of the configuration before the dropout is
    reused), and crashed parties contribute neither value nor mask.  With
    fewer than 3 survivors no two-tree pair exists, so the protocol
    degrades to a pairwise-cancelling masked psum (Σδ ≡ 0 over the
    survivors, every transmitted value still masked) with a
    ``RuntimeWarning``; ``strict=True`` raises ``RuntimeError`` there
    instead.  Returns ``(survivor sum, transcript)``, the transcript's
    rows indexed by original party ids (crashed parties see nothing).
    For the same generator it gives the reference's numbers bit for
    bit."""
    q = len(partials)
    surv = [p for p in range(q) if alive[p]]
    if not surv:
        raise ValueError("secure aggregation needs >= 1 surviving party")
    sub = [np.asarray(partials[p], dtype=np.float64) for p in surv]
    transcript = AggTranscript(messages=[[] for _ in range(q)])
    if len(surv) >= 3:
        t1, t2, _ = trees_lib.survivor_tree_pair(q, surv)
        val, sub_tr = secure_aggregate_host(sub, rng, t1, t2, mask_scale)
        # route the compact-index transcript back to original party ids
        for ci, p in enumerate(surv):
            for tag, v in sub_tr.messages[ci]:
                tag = re.sub(r"from(\d+)",
                             lambda mo: f"from{surv[int(mo.group(1))]}", tag)
                transcript.messages[p].append((tag, v))
        return val, transcript
    if strict:
        raise RuntimeError(
            f"secure aggregation: only {len(surv)} survivor(s) < 3 and "
            "strict=True — refusing to degrade below the two-tree "
            "protocol (no Definition-4 tree pair exists)")
    warnings.warn(
        f"secure aggregation degraded: only {len(surv)} survivor(s) < 3, "
        "two-tree protocol has no Definition-4 pair — falling back to "
        "pairwise-cancelling masked psum (values stay masked; the "
        "mask-sum/value-sum schedule separation is lost)", RuntimeWarning)
    s = len(surv)
    deltas = [mask_scale * rng.standard_normal(sub[0].shape)
              for _ in range(s)]
    total = np.sum(deltas, axis=0)
    deltas = [d - total / s for d in deltas]          # Σδ ≡ 0 exactly
    masked = [p + d for p, d in zip(sub, deltas)]
    # psum = all-broadcast-reduce: every survivor sees every other
    # survivor's masked value (and nothing unmasked)
    for ci, p in enumerate(surv):
        for cj, pj in enumerate(surv):
            if ci != cj:
                transcript.messages[pj].append(
                    (f"psum:from{p}", masked[ci].copy()))
    return np.sum(masked, axis=0), transcript


def seed_generator(gen: torch.Generator, seed: int, *key) -> torch.Generator:
    """Seed ``gen`` from ``(seed, *key)`` — the counterpart of
    ``jax.random.fold_in``: distinct keys give unrelated streams, and the
    same key gives the same stream on every run.  Returns ``gen``."""
    words = np.random.SeedSequence([int(seed), *map(int, key)]) \
        .generate_state(2, np.uint64)
    gen.manual_seed(int(words[0] >> np.uint64(1)))
    return gen


def mask_generator(seed: int, *key, device) -> torch.Generator:
    """A new generator on ``device`` seeded from ``(seed, *key)`` (see
    :func:`seed_generator`)."""
    return seed_generator(torch.Generator(device=torch.device(device)),
                          seed, *key)


def _party_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Every party's mask draw, (q, ...) from ``gen``.  Inside a ``make_fx``
    trace (``FusedEngine.tracing``), where nothing runs, the draw leaves
    the generator out: some torch releases cannot record one in a graph."""
    if get_proxy_mode() is not None:
        gen = None
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def tree_psum_collective_permute(x: torch.Tensor,
                                 tree: trees_lib.ReductionTree
                                 ) -> torch.Tensor:
    """Reduce the party-stacked ``x`` (q, ...) replaying ``tree``'s rounds,
    then broadcast the root's total back down the tree.

    Round by round, every scheduled pair does ``acc[dst] += acc[src]``
    (pairs within a round are disjoint, so the in-place update equals the
    reference's simultaneous ``ppermute``); the reverse rounds copy parent
    to child.  Returns (q, ...) with every party holding the total."""
    if x.shape[0] != tree.q:
        raise ValueError(f"party dimension {x.shape[0]} != tree.q {tree.q}")
    acc = x.clone()
    rounds = _round_index(tree, x.device)
    for dst, src in rounds:
        acc[dst] = acc[dst] + acc[src]
    for dst, src in reversed(rounds):
        acc[src] = acc[dst]
    return acc


@functools.lru_cache(maxsize=None)
def _round_index(tree: trees_lib.ReductionTree, device: torch.device
                 ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """``tree``'s rounds as (dst, src) index tensors on ``device``, built
    once per (tree, device): a per-call host-to-device copy could not be
    captured in a CUDA graph and would stall the stream on every
    aggregation.  The one copy goes from pinned memory without blocking,
    so even the first call does not synchronise with the device.  The
    tensors are real even when the first call comes inside a ``make_fx``
    trace over fake tensors (``FusedEngine.tracing``): a trace reads them
    as constants and the cache is never left holding fake ones."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    def index(vals):
        t = torch.tensor(vals, dtype=torch.int64)
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        return tuple((index([d for d, _ in rnd]), index([s for _, s in rnd]))
                     for rnd in tree.rounds)


def secure_psum_ring(partial: torch.Tensor, gen: torch.Generator,
                     mask_scale: float = 1.0,
                     transcript: Optional[List[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Ring-masked reduction over the party dimension (one collective).

    r_ℓ is party ℓ's seed stream and r_prev = r_{ℓ−1} its ring
    neighbour's (``roll`` by one on dimension 0), so the masks
    r_ℓ − r_{ℓ−1} cancel exactly in the sum.  Same collusion caveat as
    the reference: the two ring neighbours of ℓ can jointly strip δ_ℓ."""
    out_dtype = partial.dtype
    partial = partial.float()
    r_self = _party_normal(partial.shape, gen, partial.device)
    r_prev = torch.roll(r_self, 1, dims=0)
    masked = partial + mask_scale * (r_self - r_prev)
    if transcript is not None:
        transcript.append(masked)
    return masked.sum(0).to(out_dtype)


def secure_psum(partial: torch.Tensor, gen: torch.Generator,
                mask_scale: float = 1.0, schedule_faithful: bool = False,
                transcript: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Masked two-tree reduction over the party dimension (Algorithm 1).

    ``schedule_faithful=True`` replays the exact T1/T2 rounds of
    ``trees.default_tree_pair(q)``; otherwise both reductions are plain
    sums over the party dimension (the production fast path — security
    rests on the masks and on distinct schedules, not on the summation
    order)."""
    out_dtype = partial.dtype
    # Mask arithmetic in f32: masking/unmasking must cancel exactly enough
    # that the aggregate is lossless (bf16 partial + O(1) mask would lose
    # the partial's mantissa).
    partial = partial.float()
    delta = mask_scale * _party_normal(partial.shape, gen, partial.device)
    masked = partial + delta
    if transcript is not None:
        transcript.append(masked)
    return _xi(masked, delta, schedule_faithful).to(out_dtype)


def _xi(masked: torch.Tensor, delta: torch.Tensor,
        schedule_faithful: bool) -> torch.Tensor:
    """ξ₁ − ξ₂ over dimension 0: the masked values reduced over T1 and the
    masks over T2 of ``trees.default_tree_pair(q)`` when
    ``schedule_faithful``, else both plain sums."""
    if schedule_faithful:
        t1, t2 = trees_lib.default_tree_pair(masked.shape[0])
        xi1 = tree_psum_collective_permute(masked, t1)[0]
        xi2 = tree_psum_collective_permute(delta, t2)[0]
    else:
        xi1 = masked.sum(0)
        xi2 = delta.sum(0)
    return xi1 - xi2


# ---------------------------------------------------------------------------
# membership-aware forms (fault tolerance: party dropout / rejoin)
# ---------------------------------------------------------------------------

def _alive_fingerprint(av: torch.Tensor) -> torch.Tensor:
    """int32 fingerprint of the alive vector ``av`` (q,) of 0/1: the
    reference's, which folds it into the mask key.  An exact bitmask (bit
    p = party p) for q <= 30; wider federations fold each flag in order
    (fp ← 2·fp + av[i]) with int32 wrap-around, i.e. Σ av[i]·2^(q−1−i)
    mod 2³² read as a signed int32.  A device op (no host read)."""
    av = av.long()
    q = av.shape[0]
    if q <= 30:
        return (av << torch.arange(q, device=av.device)).sum().int()
    shift = torch.arange(q - 1, -1, -1, device=av.device)
    fp = torch.where(shift < 32, av << shift.clamp_max(31), 0).sum() \
        % (1 << 32)
    return (fp - (fp >= (1 << 31)).long() * (1 << 32)).int()


def _live(alive: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The alive flags (q,), or (q, slots) for the two-level form's
    first level, shaped to broadcast over ``like`` (q, ...)."""
    return alive.to(like.dtype).view(
        *alive.shape, *([1] * (like.dim() - alive.dim())))


def secure_psum_members(partial: torch.Tensor, gen: torch.Generator,
                        alive: torch.Tensor, mask_scale: float = 1.0,
                        transcript: Optional[List[torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Membership-safe two-tree lowering: ξ₁ = Σ alive·(z + δ) and
    ξ₂ = Σ alive·δ over the party dimension, output ξ₁ − ξ₂.  A schedule
    replay is not membership-safe (a crashed party sits on the reduction
    path), so this form never replays T1/T2; the host form
    (:func:`secure_aggregate_survivors`) carries the rebuilt trees."""
    out_dtype = partial.dtype
    partial = partial.float()
    live = _live(alive, partial)
    delta = mask_scale * _party_normal(partial.shape, gen, partial.device)
    masked = partial + delta
    if transcript is not None:
        transcript.append(live * masked)
    xi1 = (live * masked).sum(0)
    xi2 = (live * delta).sum(0)
    return (xi1 - xi2).to(out_dtype)


def secure_psum_ring_members(partial: torch.Tensor, gen: torch.Generator,
                             alive: torch.Tensor, mask_scale: float = 1.0,
                             transcript: Optional[List[torch.Tensor]] = None
                             ) -> torch.Tensor:
    """``secure_psum_ring`` on the surviving sub-ring.

    A survivor's rank r is the number of survivors before it (an
    exclusive ``cumsum`` of the alive vector); with n survivors it masks
    with R[r] − R[(r − 1) mod n] from one drawn table R (q, ...), so the
    masks cancel over the survivors for any n (a lone survivor's two rows
    coincide: δ = 0).  Crashed parties contribute neither value nor
    mask.  A (q, slots) ``alive`` runs one sub-ring per column (the
    two-level form's first level)."""
    out_dtype = partial.dtype
    partial = partial.float()
    av = (alive > 0).long()
    rank = torch.cumsum(av, 0) - av
    prev = (rank - 1) % av.sum(0).clamp_min(1)
    table = _party_normal(partial.shape, gen, partial.device)

    def rows(r):                    # table[r[i, ...], ...] along the parties
        return table.gather(0, r.view(
            *r.shape, *([1] * (table.dim() - r.dim()))).expand_as(table))

    delta = rows(rank) - rows(prev)
    masked = _live(alive, partial) * (partial + mask_scale * delta)
    if transcript is not None:
        transcript.append(masked)
    return masked.sum(0).to(out_dtype)


# ---------------------------------------------------------------------------
# two-level forms: the logical party axis as slots × parties per slot
# ---------------------------------------------------------------------------
#
# Under a packed ``PartyMesh`` party p = s·pps + i is party i of slot s.
# Level 1 reduces each slot's parties (the flat two-tree form over the
# inner axis, replaying ``trees.default_tree_pair(pps)`` under
# ``schedule_faithful``, or ring masks within the slot); level 2 runs the
# same lowering across the slots on the per-slot sums.  Every mask is a
# fresh draw from the step's generator: level 1 draws one stream per
# logical party, level 2 one per slot, so no stream serves two parties
# and none is used twice.  The reference runs level 2 once per inner
# replica (each with its own masks; the replicas agree to f32 mask
# rounding); on one device it runs once and every party receives that
# one total.


def _inner_major(partial: torch.Tensor, slots: int) -> torch.Tensor:
    """(q, ...) -> (pps, slots, ...): the slots side by side, each slot's
    parties along dimension 0, where the flat forms reduce."""
    return partial.view(slots, partial.shape[0] // slots,
                        *partial.shape[1:]).transpose(0, 1)


def secure_psum_hier(partial: torch.Tensor, gen: torch.Generator,
                     slots: int, mode: str = "two_tree",
                     mask_scale: float = 1.0,
                     schedule_faithful: bool = False,
                     transcript: Optional[List[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Two-level masked aggregation of the party-stacked ``partial``
    (q, ...) with q = slots × pps.  ``mode`` (``"two_tree"`` or
    ``"ring"``) is the lowering of both levels.  The masks cancel level
    by level, so the result is the plain sum over all q parties to f32
    rounding.  ``transcript`` receives level 1's masked (pps, slots, ...)
    values, then level 2's masked (slots, ...) slot sums."""
    out_dtype = partial.dtype
    inner = _inner_major(partial.float(), slots)
    if mode == "ring":
        z_slot = secure_psum_ring(inner, gen, mask_scale, transcript)
        tot = secure_psum_ring(z_slot, gen, mask_scale, transcript)
    else:
        z_slot = secure_psum(inner, gen, mask_scale, schedule_faithful,
                             transcript)
        tot = secure_psum(z_slot, gen, mask_scale, schedule_faithful,
                          transcript)
    return tot.to(out_dtype)


def secure_psum_hier_members(partial: torch.Tensor, gen: torch.Generator,
                             alive: torch.Tensor, slots: int,
                             mode: str = "two_tree",
                             mask_scale: float = 1.0,
                             transcript: Optional[List[torch.Tensor]] = None
                             ) -> torch.Tensor:
    """Membership-safe two-level aggregation over the parties whose
    ``alive`` (q,) flag is set: level 1 is the flat membership form within
    each slot, level 2 aggregates the per-slot survivor sums across the
    slots with each slot's any-alive flag as its liveness, so an all-dead
    slot adds neither value nor mask.  Never a schedule replay (see
    :func:`secure_psum_members`)."""
    out_dtype = partial.dtype
    inner = _inner_major(partial.float(), slots)
    av = _inner_major(alive, slots)                       # (pps, slots)
    fn = secure_psum_ring_members if mode == "ring" else secure_psum_members
    z_slot = fn(inner, gen, av, mask_scale, transcript)
    slot_alive = av.float().sum(0).clamp_max(1.0)
    return fn(z_slot, gen, slot_alive, mask_scale, transcript).to(out_dtype)


# ---------------------------------------------------------------------------
# forms over a process group: one member a slot of a device mesh
# ---------------------------------------------------------------------------
#
# A flat device mesh (one party a slot) aggregates over the model group
# with party p's stream, keyed (key..., _L1_SALT, p).  A packed one runs
# level 1 within the member's slot with its parties' streams, then level
# 2 across the slots with the slot's stream, keyed (key..., _L2_SALT, s).

_L1_SALT = 0x51071   # the parties' mask streams
_L2_SALT = 0x1e2e1   # the slots' (level 2) mask streams


class PartyStreams:
    """The mask streams one member of a device mesh draws from: one
    generator for each of its logical ``parties``, one for its ``slot``
    where the mesh is packed, and, for the ring, the stream of the party
    (flat) or slot (packed) before it.  :meth:`seed` seeds every one from
    ``(key..., salt, id)``, so the member can reproduce its own streams
    and no other's but that one.  ``identities`` names each stream as
    (salt, id), in the order of :meth:`generators`."""

    def __init__(self, parties, slot: int, q: int, slots: int, ring: bool,
                 device):
        parties = list(parties)
        dev = torch.device(device)
        ids = [(_L1_SALT, p) for p in parties]
        if q > slots:
            ids.append((_L2_SALT, slot))
        if ring:
            ids.append((_L2_SALT, (slot - 1) % slots) if q > slots
                       else (_L1_SALT, (parties[0] - 1) % q))
        self.identities = tuple(ids)
        self._gens = [torch.Generator(device=dev) for _ in ids]
        self.own = self._gens[:len(parties)]
        self.slot_gen = self._gens[len(parties)] if q > slots else None
        self.prev = self._gens[-1] if ring else None

    def seed(self, *key) -> "PartyStreams":
        for (salt, i), gen in zip(self.identities, self._gens):
            seed_generator(gen, *key, salt, i)
        return self

    def generators(self) -> List[torch.Generator]:
        return list(self._gens)


def _normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """One party's mask draw from its own stream ``gen``."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _draws(shape, gens, device) -> torch.Tensor:
    """(len(gens), *shape): each party's draw from its own stream."""
    return torch.stack([_normal(shape, g, device) for g in gens])


def psum_dist(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every member's ``x`` over ``group`` (an ``all_reduce``
    into a new tensor)."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def tree_psum_dist(x: torch.Tensor, tree: trees_lib.ReductionTree,
                   group) -> torch.Tensor:
    """Reduce every member's ``x`` over ``group`` replaying ``tree``'s
    rounds (member i is the tree's party i), then broadcast the root's
    total back down the tree: the process-group form of
    :func:`tree_psum_collective_permute`, each round one
    ``batch_isend_irecv`` of its scheduled pairs (the reference's
    ``ppermute``).  Returns the total, on every member."""
    import torch.distributed as dist
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        raise RuntimeError("gloo's point-to-point sends read host memory: "
                           "a tree replay of CUDA tensors needs NCCL")
    if dist.get_world_size(group) != tree.q:
        raise ValueError(f"group of {dist.get_world_size(group)} members "
                         f"!= tree.q {tree.q}")
    me = dist.get_group_rank(group, dist.get_rank())
    acc, buf = x.clone(), torch.empty_like(x)

    def move(pairs, up: bool) -> bool:
        """One round: src sends to dst (up) or dst to src (down); returns
        whether this member received."""
        ops = []
        for dst, src in pairs:
            frm, to = (src, dst) if up else (dst, src)
            if me == frm:
                ops.append(dist.P2POp(dist.isend, acc,
                                      dist.get_global_rank(group, to), group))
            elif me == to:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      dist.get_global_rank(group, frm),
                                      group))
        for work in (dist.batch_isend_irecv(ops) if ops else ()):
            work.wait()
        return any(me == (dst if up else src) for dst, src in pairs)

    for rnd in tree.rounds:
        if move(rnd, True):
            acc = acc + buf
    for rnd in reversed(tree.rounds):
        if move(rnd, False):
            acc = buf.clone()
    return acc


def secure_psum_dist(partial: torch.Tensor, gen: torch.Generator, group,
                     mask_scale: float = 1.0,
                     schedule_faithful: bool = False) -> torch.Tensor:
    """Algorithm 1 over ``group``: this member masks its ``partial`` with
    δ from its own stream ``gen``; the masked values are summed (over T1
    of ``trees.default_tree_pair`` when ``schedule_faithful``) and so
    are the masks (over T2), two collectives; returns ξ₁ − ξ₂ on every
    member."""
    out_dtype = partial.dtype
    partial = partial.float()
    delta = mask_scale * _normal(partial.shape, gen, partial.device)
    masked = partial + delta
    if schedule_faithful:
        import torch.distributed as dist
        t1, t2 = trees_lib.default_tree_pair(dist.get_world_size(group))
        xi1 = tree_psum_dist(masked, t1, group)
        xi2 = tree_psum_dist(delta, t2, group)
    else:
        xi1 = psum_dist(masked, group)
        xi2 = psum_dist(delta, group)
    return (xi1 - xi2).to(out_dtype)


def secure_psum_ring_dist(partial: torch.Tensor, gen: torch.Generator,
                          gen_prev: torch.Generator, group,
                          mask_scale: float = 1.0) -> torch.Tensor:
    """Ring masks over ``group``: this member masks with r_self − r_prev,
    r_self from its own stream ``gen``, r_prev from the stream of the
    member before it (``gen_prev``), so the masks cancel in the one
    ``all_reduce``."""
    out_dtype = partial.dtype
    partial = partial.float()
    r_self = _normal(partial.shape, gen, partial.device)
    r_prev = _normal(partial.shape, gen_prev, partial.device)
    masked = partial + mask_scale * (r_self - r_prev)
    return psum_dist(masked, group).to(out_dtype)


def secure_psum_members_dist(partial: torch.Tensor, gen: torch.Generator,
                             alive: torch.Tensor, group,
                             mask_scale: float = 1.0) -> torch.Tensor:
    """:func:`secure_psum_members` over ``group``: this member's 0-d
    ``alive`` flag gates both its masked value and its mask, so the masks
    cancel over the survivors; never a schedule replay."""
    out_dtype = partial.dtype
    partial = partial.float()
    live = alive.to(partial.dtype)
    delta = mask_scale * _normal(partial.shape, gen, partial.device)
    xi1 = psum_dist(live * (partial + delta), group)
    xi2 = psum_dist(live * delta, group)
    return (xi1 - xi2).to(out_dtype)


def secure_psum_hier_dist(partial: torch.Tensor, streams: PartyStreams,
                          group, mode: str = "two_tree",
                          mask_scale: float = 1.0,
                          schedule_faithful: bool = False) -> torch.Tensor:
    """Two-level aggregation of this member's slot, ``partial`` (pps, ...)
    its parties' values: level 1 the flat form over dimension 0 with each
    party's own stream (ring masks within the slot under ``"ring"``),
    level 2 the process-group form across the slots with the slot's
    stream.  The result is the plain sum over all q parties to f32
    rounding, on every member."""
    out_dtype = partial.dtype
    partial = partial.float()
    draws = _draws(partial.shape[1:], streams.own, partial.device)
    if mode == "ring":
        masked = partial + mask_scale * (draws - torch.roll(draws, 1, 0))
        tot = secure_psum_ring_dist(masked.sum(0), streams.slot_gen,
                                    streams.prev, group, mask_scale)
    else:
        delta = mask_scale * draws
        z_slot = _xi(partial + delta, delta, schedule_faithful)
        tot = secure_psum_dist(z_slot, streams.slot_gen, group, mask_scale,
                               schedule_faithful)
    return tot.to(out_dtype)


def secure_psum_hier_members_dist(partial: torch.Tensor,
                                  streams: PartyStreams,
                                  alive: torch.Tensor, group,
                                  mask_scale: float = 1.0,
                                  mode: str = "two_tree",
                                  key: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Membership-safe two-level aggregation over ``group``: level 1
    gates each of the slot's parties by its ``alive`` (pps,) flag, level
    2 the slot's sum by its any-alive flag, so an all-dead slot adds
    neither value nor mask.  ``"two_tree"``: both levels the masked-psum
    form.  ``"ring"``: level 1 a sub-ring over the slot's survivors, each
    masking with its own stream's draw less its predecessor's (the
    survivor of the rank before, found by a device index), level 2
    :func:`secure_psum_ring_members_dist` across the slots on the step
    key ``key``."""
    out_dtype = partial.dtype
    partial = partial.float()
    live = _live(alive, partial)
    draws = _draws(partial.shape[1:], streams.own, partial.device)
    slot_alive = alive.float().amax().clamp_max(1.0).view(1)
    if mode == "ring":
        av = (alive > 0).long()
        rank = torch.cumsum(av, 0) - av
        prev = (rank - 1) % av.sum().clamp_min(1)
        # party i's predecessor: the survivor whose rank is prev[i]
        pred = ((rank[None, :] == prev[:, None]) & (av[None, :] > 0)) \
            .long().argmax(1)
        delta = mask_scale * (draws - draws.index_select(0, pred))
        z_slot = (live * (partial + delta)).sum(0)
        return secure_psum_ring_members_dist(
            z_slot, key, gather_flags_dist(slot_alive, group), group,
            mask_scale).to(out_dtype)
    delta = mask_scale * draws
    z_slot = (live * (partial + delta)).sum(0) - (live * delta).sum(0)
    return secure_psum_members_dist(z_slot, streams.slot_gen, slot_alive[0],
                                    group, mask_scale).to(out_dtype)


# ---------------------------------------------------------------------------
# the ring's survivor-rank stream over a process group
# ---------------------------------------------------------------------------
#
# Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
# words: each 32 x 32-bit product is formed from 16-bit limbs, so no
# intermediate reaches 2^35 (torch's signed overflow is not a contract).
# The words are the same on every device; the Box–Muller step runs in
# float64 and rounds to float32 once, so a device's normals lie within
# float32 rounding of another's.

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)    # the round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)    # the key schedule's increments
_PHILOX_ROUNDS = 10


def key_words(*key) -> Tuple[int, int]:
    """Two 32-bit words from the ints ``key`` (as :func:`seed_generator`
    seeds a generator): the counter stream's key, to be filled into a
    device buffer."""
    w = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    return int(w[0]), int(w[1])


def _pair_const(vals, like: torch.Tensor) -> torch.Tensor:
    """(2, 1) int64 of two constants, made by device arithmetic (no host
    copy, so a captured step can make it)."""
    a, b = vals
    return (torch.arange(2, device=like.device, dtype=torch.int64) * (b - a)
            + a).view(2, 1)


def _philox(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox-4x32-10 of the counters ``ctr`` (4, k) under the key words
    ``key`` (2,), both int64 tensors of 32-bit words; returns (4, k)."""
    m = _pair_const(_PHILOX_M, ctr)
    m_hi, m_lo = m >> 16, m & 0xFFFF
    w = _pair_const(_PHILOX_W, ctr)
    k = (key & _M32).view(2, 1)
    x = ctr
    for _ in range(_PHILOX_ROUNDS):
        a = x[0::2]                                  # words 0 and 2
        a_hi, a_lo = a >> 16, a & 0xFFFF
        mid = a_hi * m_lo + a_lo * m_hi              # < 2^33
        t = a_lo * m_lo + ((mid & 0xFFFF) << 16)     # < 2^33
        lo = t & _M32
        hi = a_hi * m_hi + (mid >> 16) + (t >> 32)
        # (hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0)
        even = hi.flip(0) ^ x[1::2] ^ k
        x = torch.stack((even, lo.flip(0)), 1).view(4, -1)
        k = (k + w) & _M32
    return x


def _counter_normal(key: torch.Tensor, fp: torch.Tensor, rows: torch.Tensor,
                    numel: int) -> torch.Tensor:
    """(len(rows), numel) float32 standard normals: row i is the stream
    of counter (j, rows[i], fp, key[2]) under the key words key[:2], four
    normals per counter block j (Box–Muller on its four words).  ``key``
    is an int64 device tensor of three 32-bit words (the step key),
    ``fp`` the 0-d fingerprint, ``rows`` int64 (k,).  Device ops only."""
    nb = (numel + 3) // 4
    k = rows.shape[0]
    j = torch.arange(nb, device=rows.device, dtype=torch.int64)
    ctr = torch.stack([j.expand(k, nb), (rows & _M32)[:, None].expand(k, nb),
                       (fp.long() & _M32).expand(k, nb),
                       (key[2] & _M32).expand(k, nb)]).view(4, -1)
    words = _philox(ctr, key[:2]).view(4, k, nb)
    u = ((words >> 8).double() + 0.5) * 2.0 ** -24           # in (0, 1)
    rad = torch.sqrt(-2.0 * torch.log(u[0::2]))               # (2, k, nb)
    ang = (2.0 * np.pi) * u[1::2]
    z = torch.stack((rad * torch.cos(ang), rad * torch.sin(ang)))
    return z.permute(2, 3, 1, 0).reshape(k, 4 * nb)[:, :numel].float()


def _ring_member_mask(key: torch.Tensor, alive_all: torch.Tensor,
                      rows: torch.Tensor, shape) -> torch.Tensor:
    """The ring masks (len(rows), *shape) of the members ``rows`` (int64
    positions in ``alive_all``): the member of survivor rank r (an
    exclusive cumsum of the alive vector) draws R[r] − R[(r − 1) mod
    n_alive] from :func:`_counter_normal` keyed by ``key`` and the
    fingerprint of ``alive_all``, so the masks cancel over the survivors
    for any survivor count (a lone survivor's two rows coincide: 0).  A
    dead member's mask is computed all the same; the caller gates it.  No
    collective."""
    av = (alive_all > 0).long()
    rank = torch.cumsum(av, 0) - av
    r = rank.index_select(0, rows)
    prev = (r - 1) % av.sum().clamp_min(1)
    numel = int(np.prod(shape, dtype=np.int64))
    draws = _counter_normal(key, _alive_fingerprint(av), torch.cat([r, prev]),
                            numel)
    n = rows.shape[0]
    return (draws[:n] - draws[n:]).view(n, *shape)


def gather_flags_dist(flags: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``flags`` (k,) side by side over ``group``, (k·n,)
    float32: an ``all_reduce`` of a zero vector holding this member's flags
    at its own positions."""
    import torch.distributed as dist
    k = flags.shape[0]
    me = dist.get_group_rank(group, dist.get_rank())
    full = torch.zeros(k * dist.get_world_size(group), dtype=torch.float32,
                       device=flags.device)
    full.narrow(0, me * k, k).copy_(flags)
    dist.all_reduce(full, group=group)
    return full


def secure_psum_ring_members_dist(partial: torch.Tensor, key: torch.Tensor,
                                  alive_all: torch.Tensor, group,
                                  mask_scale: float = 1.0) -> torch.Tensor:
    """:func:`secure_psum_ring_members` over ``group``: ``alive_all`` (n,)
    is every member's flag (:func:`gather_flags_dist`); this member masks
    its ``partial`` with :func:`_ring_member_mask`'s two rows of the
    counter stream on the step key ``key`` and sends it gated by its own
    flag, one ``all_reduce``; returns the survivor sum on every member.
    Every member enters the collective, a dead one with zeros."""
    import torch.distributed as dist
    out_dtype = partial.dtype
    partial = partial.float()
    me = dist.get_group_rank(group, dist.get_rank())
    rows = torch.full((1,), me, dtype=torch.int64, device=partial.device)
    delta = _ring_member_mask(key, alive_all, rows, partial.shape)[0]
    masked = alive_all[me] * (partial + mask_scale * delta)
    return psum_dist(masked, group).to(out_dtype)
