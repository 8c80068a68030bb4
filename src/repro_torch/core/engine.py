"""The fused VFB² engine on PyTorch: serving's forward and aggregation, and
the linear training epochs.

The port of ``repro.core.engine``: the configuration, the vertical packing
helpers and the linear parts of ``FusedEngine`` — the X-block
contractions (``_fwd``, ``_bwd``, ``_bwd_doms``, ``_bwd_doms_wide`` and
the pipelined step's ``_pipe`` / ``_pipe_doms`` / ``_pipe_doms_wide``:
the vfl_grad kernel's forward, backward and split-batch fused modes), the
masked secure aggregation over the party axis (``_agg``, Algorithm 1),
the SGD / SVRG / SAGA epochs with their full-dataset passes
(``full_gradient``, ``saga_init``), their multi-dominator, pipelined and
multi-dominator pipelined forms, the bounded-delay SGD epochs in the same
four forms (``core.staleness`` semantics: per-party gradient rings), the
deep (party-local two-layer encoder) SGD and SVRG epochs in the four
fresh and pipelined forms with ``deep_full_gradient``, the bounded-delay
deep SGD epochs in the same four forms (per-party, or per (party,
dominator), encoder gradient rings), the faulted and guarded linear and
deep epochs (``core.faults`` semantics), and the linear and deep
objectives.  A ``PartyMesh`` makes the masked aggregation two-level and
slices the fresh SGD and SVRG minibatches over its data axis.

Party axis: the q parties are the leading dimension of every
party-stacked tensor on one device (``xs`` is (q, n, dp), an iterate
(q, dp)), which is the single-device emulation the JAX engine runs under
``vmap``.  A party program written for one party in the reference is
written here once for all parties at once: a contraction takes the party
dimension into the kernel's launch, and the aggregation reduces over it.

Epochs.  The reference runs an epoch as one compiled program with no host
sync inside.  Here an epoch takes an explicit ``(steps, batch)`` int64
schedule ``idx`` (the reference draws it from its key inside the
program; see ``core.algorithms.epoch_indices``) and a ``mask_key`` tuple
of ints that seeds the epoch's mask stream.  On the card its step runs
once eagerly, is captured once as a CUDA graph per (epoch kind, schedule
shape) and is replayed for the remaining steps: the step reads its row of
``idx`` through a device counter that the graph increments, the learning
rate from a device scalar, and its masks from one generator registered
with the graph, so a replay draws fresh masks and no host sync happens
inside the epoch.  A graph launches its kernels without calling back into
Python, so the engine adds each replay's launches to the kernel's
counters itself.  On the CPU the same step runs eagerly ``steps`` times.

Pipelined epochs (the τ = 1 schedule: backward(t) ∥ forward(t+1)) run a
forward prologue eagerly, ``steps − 1`` interior steps through the same
loop (each one split-batch fused kernel launch over the gathered rows of
schedule rows t and t+1), and a backward epilogue eagerly.  The
aggregate of the next round's forward is carried in a static buffer of
the loop.

Tracing (the counterpart of the reference's ``party_program`` and
``*_epoch_jaxpr`` probes).  Under ``eng.tracing()`` an epoch call loads
its loop as usual but neither runs nor captures its step: it records one
``make_fx`` trace of the whole epoch over fake tensors (the pipelined
forms' eager prologue and epilogue included, the step once) as its
kind's program, ``party_program(kind)``, an ``fx.GraphModule`` whose
party axis is dim 0.  The step's nodes carry ``meta["step"]``, the loop
buffers' placeholders ``meta["buffer"]`` and ``meta["party_dims"]``, and
the engine's own tensors (the feature block ``xs`` first) are named by
identity in ``gm.meta``; ``repro_torch.analysis`` reads them.  The
``*_epoch_graph`` methods trace one epoch and return its program.  Each
``ops.vfl_grad`` call is one ``repro_torch.vfl_grad`` node, so a step's
nodes count its launches on the card.

Device mesh.  Given ``PartyMesh(mesh=DeviceMesh)`` each rank holds one
slot of parties (``PartyMesh.parties``): ``xs`` is its (pps, n, dp)
slice and every party-stacked tensor its (pps, ...) rows, as
``shard_map`` binds ``P("model")`` — the iterates, the deep leaves
(``w1 b1 w2 head``; the head's copies stay equal on every rank, each
rank updating its rows from the replicated aggregate), SVRG's snapshot
and μ, the gradient rings and the delays; ``y``, ϑ, the schedule and
the step counter are replicated, as ``P()``.  :meth:`FusedEngine.local`
slices a whole (q, ...) tensor to the rank's rows and
:meth:`FusedEngine.gather` undoes it.  Every cross-party aggregation is
a collective over the mesh's model group (``secure_agg``'s ``*_dist``
forms), each rank drawing only its own parties' masks
(``secure_agg.PartyStreams``).  On a data axis a fresh linear SGD or
SVRG step takes the rank's slice of the minibatch, with mask streams of
its own, and sums the gradient over the data group; every other epoch
runs whole on each data shard, which draw the same streams and agree.
There run the linear SGD, SVRG and SAGA epochs in their
single-dominator, multi-dominator and pipelined forms with
``full_gradient``, ``saga_init`` and ``objective``; the bounded-delay
linear and deep epochs in their four forms; the eight deep epochs with
``deep_full_gradient`` and ``deep_objective``; ``pack_deep`` and
``unpack_deep``; the six linear and four deep faulted and guarded
epochs, whose survivor aggregation is a membership form over the model
group (``_agg_members``; the ring's masks from a counter stream on the
loop's step key ``key``), with the fault channels, the rings, the delays
and the telemetry the rank's rows.  Tracing raises
``NotImplementedError`` there (ROADMAP A17b3).  Under NCCL an epoch is
captured with its collectives as on one card; gloo is never captured:
its steps run eagerly (its collectives on CUDA tensors go through the
host), as the mesh's backend decides.  Every rank calls every entry
point.

Device rule: ``FusedEngine`` defaults to ``device="cuda"`` and raises
without a card; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import PartyLayout, last_occurrence
from repro_torch.core.deep_vfl import DeepVFLParams
from repro_torch.core.faults import HealthStats, apply_corruption
from repro_torch.core.losses import Problem
from repro_torch.core.secure_agg import (PartyStreams, gather_flags_dist,
                                         key_words, mask_generator,
                                         psum_dist, secure_psum,
                                         secure_psum_dist, secure_psum_hier,
                                         secure_psum_hier_dist,
                                         secure_psum_hier_members,
                                         secure_psum_hier_members_dist,
                                         secure_psum_members,
                                         secure_psum_members_dist,
                                         secure_psum_ring,
                                         secure_psum_ring_dist,
                                         secure_psum_ring_members,
                                         secure_psum_ring_members_dist,
                                         seed_generator)
from repro_torch.kernels import ops
from repro_torch.kernels import vfl_grad as _vg
from repro_torch.sharding.api import PartyMesh

# mask-stream tags, one per entry point (the reference's fold_in constants),
# and the data shard's (the reference's _dkey)
_TAG_STEPS, _TAG_FULL, _TAG_SAGA_INIT, _TAG_DATA = 0x5EC, 0xF, 0xA, 0xDA7A
# the deep parameter leaves, as the loops' buffers name them
_DEEP = ("w1", "b1", "w2", "head")
# the party dimension of a loop buffer where it is not dim 0: the schedule,
# the counters, the learning rate and the carried aggregate have none; the
# fault channels and the health telemetry (4, q, steps) hold it at dim 1
_BUF_PARTY_DIM = {"idx": None, "t": None, "lr": None, "step": None,
                  "agg": None, "chan": 1, "health": 1}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static knobs of the fused engine.

    Every X-block contraction goes through ``kernels.ops.vfl_grad``: the
    CUDA kernel on the card, its plain version on the CPU, for minibatch
    steps and full-dataset passes alike.  The reference's ``use_kernel``
    and ``kernel_max_rows`` choose between its Pallas kernel and XLA; here
    the other route would be cuBLAS, which is not the port, so they have
    no counterpart.  The reference's ``axis``, ``interpret``, ``block_b``,
    ``block_d`` and ``donate`` have no meaning here either: the party axis
    is a tensor dimension, the kernel is compiled (never interpreted) and
    picks its own tiling, and the epochs update their buffers in place.
    """

    secure: str = "off"              # "off" | "two_tree" | "ring"
    mask_scale: float = 1.0
    schedule_faithful: bool = False  # replay exact T1/T2 rounds


# ---------------------------------------------------------------------------
# vertical packing: (n, d) features -> (q, n, dp) padded party blocks
# ---------------------------------------------------------------------------

def party_widths(layout: PartyLayout) -> np.ndarray:
    return np.asarray([hi - lo for lo, hi in layout.bounds], np.int64)


def _parties(layout: PartyLayout, parties):
    return range(layout.q) if parties is None else parties


def pack_features(x, layout: PartyLayout, device,
                  parties=None) -> torch.Tensor:
    """Stack per-party feature blocks, zero-padded to the widest block.

    ``x`` is an (n, d) numpy array or tensor; a tensor already on
    ``device`` is packed there without a host copy.  ``parties`` (default
    all q) packs only those parties' blocks, in their order."""
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    n = xt.shape[0]
    dp = int(party_widths(layout).max())
    ps = _parties(layout, parties)
    xs = torch.zeros((len(ps), n, dp), dtype=torch.float32, device=device)
    for i, p in enumerate(ps):
        lo, hi = layout.bounds[p]
        xs[i, :, : hi - lo] = xt[:, lo:hi]
    return xs


def pack_vec(v, layout: PartyLayout, device, parties=None) -> torch.Tensor:
    """(d,) coordinate vector -> (q, dp) party-stacked, zero-padded; only
    the rows of ``parties`` where given."""
    vt = torch.as_tensor(v, dtype=torch.float32, device=device)
    dp = int(party_widths(layout).max())
    ps = _parties(layout, parties)
    out = torch.zeros((len(ps), dp), dtype=torch.float32, device=device)
    for i, p in enumerate(ps):
        lo, hi = layout.bounds[p]
        out[i, : hi - lo] = vt[lo:hi]
    return out


def dominator_onehot(m: int, batch: int, device="cpu") -> torch.Tensor:
    """(m·B, m) selector: row r of the concatenated minibatch block belongs
    to dominator r // B.  ``ϑ[:, None] * dominator_onehot(m, B)`` is the
    block-diagonal Θ whose columns are the m dominators' ϑ vectors — the
    kernel's M axis.  Built with device arithmetic only (no host copy), so
    a captured step can build it."""
    seg = torch.arange(m * batch, device=device) // batch
    return (seg[:, None] == torch.arange(m, device=device)[None, :]).float()


def dom_block_cols(cots: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m·B, K) per-row cotangents -> (..., m·B, m·K) block-diagonal
    columns: dominator j's rows fill column block j, zeros elsewhere.  The
    vector-valued (deep) form of the block-diagonal Θ: one XᵀΘ gives all m
    per-dominator Jacobian-transpose slabs from one pass over X."""
    rows, k = cots.shape[-2:]
    sel = dominator_onehot(m, rows // m, cots.device).to(cots.dtype)
    return (sel[:, :, None] * cots[..., :, None, :]) \
        .reshape(*cots.shape[:-2], rows, m * k)


def _seg_contract(rows: torch.Tensor, cots: torch.Tensor,
                  m: int) -> torch.Tensor:
    """(q, D, m, K) per-dominator segment contraction in plain torch: slab
    j is rows_jᵀ·cots_j over dominator j's B rows of the concatenated
    (q, m·B, D) block, with cots (m·B, K) shared by the parties or
    (q, m·B, K).  For the one place a launch must not be issued (the
    pipelined step's layer 2)."""
    q, r, d = rows.shape
    b = r // m
    g = rows.reshape(q, m, b, d).transpose(2, 3) \
        @ cots.reshape(*cots.shape[:-2], m, b, cots.shape[-1])
    return g.permute(0, 2, 1, 3)


def pack_mask(layout: PartyLayout, active_only: bool = False,
              device="cpu", parties=None) -> torch.Tensor:
    """(q, dp) update mask: layout's trainable blocks minus the padding
    (the rows of ``parties`` where given)."""
    d = layout.bounds[-1][1]
    return pack_vec(layout.update_mask(d, active_only), layout, device,
                    parties)


def unpack_vec(vq, layout: PartyLayout) -> np.ndarray:
    """(q, dp) party-stacked -> (d,) coordinate vector (drops padding)."""
    vq = torch.as_tensor(vq).detach().cpu().numpy()
    return np.concatenate([vq[p, : hi - lo]
                           for p, (lo, hi) in enumerate(layout.bounds)])


def pack_deep_params(params: DeepVFLParams, layout: PartyLayout, device,
                     parties=None):
    """``DeepVFLParams`` -> party-stacked ``(w1q, b1q, w2q, headq)``.

    ``w1q`` (q, dp, hidden) zero-pads each party's first encoder layer to
    the widest feature block; ``headq`` (q, d_rep) replicates the active
    parties' head (the stand-in for the dominator broadcasting ϑ_z).
    ``parties`` (default all q) packs only those parties' rows."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    dp = int(party_widths(layout).max())
    hidden = int(params.enc_w1[0].shape[1])
    ps = _parties(layout, parties)
    w1q = torch.zeros((len(ps), dp, hidden), dtype=torch.float32,
                      device=device)
    for i, p in enumerate(ps):
        lo, hi = layout.bounds[p]
        w1q[i, : hi - lo] = f32(params.enc_w1[p])
    b1q = torch.stack([f32(params.enc_b1[p]) for p in ps])
    w2q = torch.stack([f32(params.enc_w2[p]) for p in ps])
    headq = f32(params.head)[None, :].repeat(len(ps), 1)
    return w1q, b1q, w2q, headq


def unpack_deep_params(pq, layout: PartyLayout) -> DeepVFLParams:
    """Party-stacked deep params -> ``DeepVFLParams`` (drops padding)."""
    w1q, b1q, w2q, headq = pq
    return DeepVFLParams([w1q[p, : hi - lo].clone()
                          for p, (lo, hi) in enumerate(layout.bounds)],
                         [b.clone() for b in b1q],
                         [w.clone() for w in w2q],
                         headq[0].clone())


def trace_program(fn, inputs: dict, party_dims: dict, consts=()):
    """``make_fx`` trace of ``fn(inputs)`` over fake copies of the tensors
    in ``inputs`` (a dict of named tensors; nothing runs and no input
    changes).  Returns the ``fx.GraphModule``: each placeholder's
    ``meta["buffer"]`` is its name in ``inputs`` and
    ``meta["party_dims"]`` the dims of it that index parties
    (``party_dims[name]``: a dim, or None for none); ``gm.meta["consts"]``
    maps each ``get_attr`` constant that is one of ``consts`` — (tensor,
    party dim or None, is the feature block) triples, matched by identity —
    to ``(party dims, is the feature block)``, and ``gm.meta["party_dim"]``
    is 0, the party axis of every party-stacked tensor."""
    from torch.fx.experimental.proxy_tensor import make_fx

    keys = list(inputs)
    gm = make_fx(lambda *ts: fn(dict(zip(keys, ts))), tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*inputs.values())
    holders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, key in zip(holders, keys):
        pd = party_dims.get(key)
        node.meta["buffer"] = key
        node.meta["party_dims"] = () if pd is None else (pd,)
    known = {}
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        val = getattr(gm, node.target)
        for t, pd, source in consts:
            if val is t:
                known[node.target] = ((() if pd is None else (pd,)), source)
                break
    if not hasattr(gm, "meta"):
        gm.meta = {}
    gm.meta.update(party_dim=0, consts=known)
    return gm


def _mark_step(fn) -> None:
    """Call ``fn`` inside a ``make_fx`` trace and mark the nodes it adds
    with ``meta["step"]``: the nodes of one step of the epoch."""
    from torch.fx.experimental import proxy_tensor

    mode = proxy_tensor.get_proxy_mode()
    graph = mode.tracer.graph
    before = len(graph.nodes)
    fn()
    for node in list(graph.nodes)[before:]:
        node.meta["step"] = True


def _ring_flat(rings, doms: bool) -> torch.Tensor:
    """A deep epoch's three encoder rings (q, τ+1, ...) -> one flat ring
    (q, τ+1, m or 1, F): each (party, slot, dominator) row holds its w1,
    b1 and w2 slabs side by side, so that a step writes and reads the
    ring once."""
    return torch.cat([(r.movedim(-2, 2) if doms else r.unsqueeze(2))
                      .flatten(3) for r in rings], 3)


def _ring_split(flat, leaves, doms: bool):
    """The inverse of :func:`_ring_flat`, in new storage: the rings of the
    party-stacked ``leaves`` (w1q, b1q, w2q, ...)."""
    out = []
    for part, a in zip(flat.split([a[0].numel() for a in leaves[:3]], 3),
                       leaves):
        r = part.reshape(*flat.shape[:3], *a.shape[1:])
        out.append((r.movedim(2, -2) if doms else r.squeeze(2))
                   .clone(memory_format=torch.contiguous_format))
    return tuple(out)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Parts(NamedTuple):
    """One algorithm's step in the pieces that its fresh steps, its
    pipelined steps and its pipelined epilogue share."""

    cols: Callable        # cols(b) -> the forward columns W
    theta: Callable       # theta(b, agg, ib, yb) -> (ϑ, denom, aux)
    apply: Callable       # apply(b, g, aux): the update, in place on b
    doms: bool            # ϑ is the m dominators' (block-diagonal Θ)


class _DeepParts(NamedTuple):
    """One deep epoch kind's round, shared by its fresh steps, its
    pipelined steps and its pipelined epilogue."""

    sides: tuple          # ("",), or SVRG's iterate and snapshot ("", "s")
    mdom: int             # the dominators whose updates a step carries
    doms: bool            # per-dominator gradients (the delayed multi forms)
    apply: Callable       # apply(b, g): the update from the four gradients


class _StepLoop:
    """The static buffers of one epoch kind at one schedule shape — the
    carried state, the schedule ``idx``, the step counter ``t`` and the
    learning rate ``lr`` — and, on the card, the step's CUDA graph and the
    kernel launches one replay makes."""

    def __init__(self, bufs):
        self.bufs = bufs
        self.graph = None
        self.per_step = None


class FusedEngine:
    """Holds the packed vertical data and the security configuration, and
    runs the kernel-backed contractions, the masked aggregation and the
    linear and deep epochs.

    Iterates are **party-stacked**: a linear iterate ``wq`` is (q, dp);
    use :meth:`pack_w`/:meth:`unpack_w` at the boundary.  SAGA's state is
    ``tabq`` (q, n), every party's copy of the ϑ̃ table, and ``avgq``
    (q, dp), as in the reference.  ``active_only=True`` freezes the
    passive parties' blocks (AFSVRG-VP).  Deep parameters are the
    party-stacked ``pq = (w1q, b1q, w2q, headq)`` of :meth:`pack_deep`;
    ``active_only`` freezes the passive encoders too (``trainq``).

    ``mesh`` is a :class:`~repro_torch.sharding.api.PartyMesh` (or None,
    the flat layout).  Without a device mesh it runs on this one device:
    a packed mesh routes every masked aggregation through the two-level
    forms (under ``off`` the plain sum stays, so a packed ``off`` epoch is
    the flat one bit for bit), and ``data_shards > 1`` slices the fresh
    SGD and SVRG minibatches (:meth:`_sliced_step`).  With one, each rank
    holds its slot's ``qloc`` parties (see the module's "Device mesh"):
    the iterates, ``tabq``, ``avgq``, the deep leaves, the gradient rings
    and the delays are the rank's rows; :meth:`pack_w` and
    :meth:`pack_deep` make them, :meth:`local` slices a whole tensor to
    them, and :meth:`unpack_w`, :meth:`unpack_deep` and :meth:`gather`
    gather the whole.
    """

    def __init__(self, problem: Problem, x, y, layout: PartyLayout,
                 cfg: EngineConfig = EngineConfig(), *,
                 active_only: bool = False, mesh=None, device="cuda"):
        if cfg.secure not in ("off", "two_tree", "ring"):
            raise ValueError(f"unknown secure mode {cfg.secure!r} "
                             "(expected 'off', 'two_tree' or 'ring')")
        if mesh is not None:
            if not isinstance(mesh, PartyMesh):
                raise TypeError(
                    f"mesh must be a PartyMesh or None; got "
                    f"{type(mesh).__name__}")
            if mesh.q != layout.q:
                raise ValueError(
                    f"PartyMesh.q={mesh.q} != layout.q={layout.q}")
        self.device = resolve_device(device)
        # the device mesh's PartyMesh, or None on one device
        self._dist = mesh if mesh is not None and mesh.mesh is not None \
            else None
        if self._dist is not None \
                and self._dist.mesh.device_type != self.device.type:
            raise ValueError(f"a {self._dist.mesh.device_type} device mesh "
                             f"with an engine on {self.device}")
        self._slots = mesh.slots if mesh is not None else layout.q
        self._ddp = mesh.data_shards if mesh is not None else 1
        self.problem = problem
        self.layout = layout
        self.cfg = cfg
        self.q = layout.q
        # this rank's logical parties (all q on one device) and their count
        self.parties = range(layout.q) if self._dist is None \
            else self._dist.parties
        self.qloc = len(self.parties)
        self.xs = pack_features(x, layout, self.device,
                                self.parties)         # (qloc, n, dp)
        self.n = int(self.xs.shape[1])
        self.dp = int(self.xs.shape[2])
        self.y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        self.maskq = pack_mask(layout, active_only, self.device,
                               self.parties)
        # (q,) trainability of the deep encoders' b1 and w2 (no coordinate
        # rows for maskq to act on): active_only freezes the passive ones
        self.trainq = torch.tensor(
            [1.0 if (not active_only or p < layout.m) else 0.0
             for p in self.parties], device=self.device)
        # party p's sample i is row p*n + i of xs viewed as (q*n, dp)
        self._row0 = torch.arange(self.qloc, device=self.device)[:, None] \
            * self.n
        self._pair_rows = torch.arange(2, device=self.device)
        # every epoch's masks: one generator, re-seeded per call, which the
        # step graphs register so that each replay draws fresh masks; on a
        # device mesh the rank's own parties' streams instead
        if self._dist is None:
            self._gen = torch.Generator(device=self.device)
            self._capturable = self.device.type == "cuda"
        else:
            self._gen = self._streams()
            self._mgroup = self._dist.model_group
            self._dgroup = self._dist.data_group
            self._didx = self._dist.data_index
            self._capturable = self.device.type == "cuda" \
                and self._dist.backend == "nccl"
            # the groups' first collectives, outside any capture
            for grp in (self._mgroup, self._dgroup):
                psum_dist(torch.zeros(1, device=self.device), grp)
        self._loops = {}
        self._tracing = False
        self._programs = {}

    # -- the device mesh -------------------------------------------------------

    def _streams(self) -> PartyStreams:
        """A new set of this rank's mask streams (unseeded)."""
        pm = self._dist
        return PartyStreams(self.parties, pm.slot, self.q, self._slots,
                            self.cfg.secure == "ring", self.device)

    def mask_streams(self, *key):
        """The masks of one aggregation keyed by ``key``: a generator
        seeded from it on one device; on a device mesh this rank's
        :class:`~repro_torch.core.secure_agg.PartyStreams`, each seeded
        from ``key`` and its party or slot."""
        if self._dist is None:
            return mask_generator(*key, device=self.device)
        return self._streams().seed(*key)

    def _reseed(self, *key):
        """Re-seed the epochs' mask streams from ``key``; returns them."""
        if self._dist is None:
            return seed_generator(self._gen, *key)
        return self._gen.seed(*key)

    def _generators(self):
        return [self._gen] if self._dist is None else self._gen.generators()

    def _local_only(self, what: str) -> None:
        """Raise for an entry point that has no device-mesh form yet."""
        if self._dist is not None:
            raise NotImplementedError(
                f"{what} on a device mesh is not ported (ROADMAP A17b3); "
                "run it on one device (PartyMesh without mesh=)")

    def _dsum(self, g):
        """Sum a rank's gradient over its data group (the reference's
        ``_dsum``); the data shards share a party's trust domain, so the
        sum is plain."""
        return psum_dist(g, self._dgroup) if self._ddp > 1 else g

    def gather(self, tq) -> torch.Tensor:
        """The whole party-stacked (q, ...) tensor of every rank's rows
        ``tq`` (qloc, ...) over the model group; ``tq`` itself on one
        device.  Every rank of the group calls it."""
        if self._dist is None:
            return tq
        import torch.distributed as dist
        tq = tq.contiguous()
        parts = [torch.empty_like(tq) for _ in range(self._slots)]
        dist.all_gather(parts, tq, group=self._mgroup)
        return torch.cat(parts, 0)

    def local(self, tq) -> torch.Tensor:
        """This rank's rows (qloc, ...) of the whole party-stacked
        (q, ...) tensor ``tq``, the inverse of :meth:`gather` (as
        ``shard_map`` slices a ``P("model")`` argument); ``tq`` itself on
        one device."""
        if self._dist is None:
            return tq
        return torch.as_tensor(tq).narrow(0, self.parties.start, self.qloc)

    def _check_rows(self, what: str, a) -> None:
        """Raise unless ``a`` holds this engine's qloc party rows."""
        if np.shape(a)[0] != self.qloc:
            raise ValueError(f"{what} holds {np.shape(a)[0]} party rows; "
                             f"this engine holds {self.qloc}")

    # -- X-block contractions (the vfl_grad kernel) ---------------------------

    def _fwd(self, xb, wcols):
        """(B, dp) @ (dp, M) -> (B, M) forward partial products; with a
        leading party axis, (q, B, dp) @ (q, dp, M) -> (q, B, M) in one
        kernel launch.  A rank-1 ``wcols`` gives a rank-1 result."""
        return ops.vfl_grad(xb, wcols, None, mode="forward")[0]

    def _bwd(self, xb, thq, denom: int):
        """BUM data gradients XᵀΘ/denom of every party in one kernel
        launch (``w=None``; the caller adds the regularizer): xb
        (q, B, dp) with the party-stacked Θ (q, B) or (q, B, M) -> (q, dp)
        or (q, dp, M).  A Θ shared by every party comes as
        :meth:`_share`'s view, which the kernel reads without copies."""
        return ops.vfl_grad(xb, None, thq, mode="backward", denom=denom)[1]

    def _dom_cols(self, cots, m: int):
        """The block-diagonal columns (``dom_block_cols``) of m dominators'
        concatenated (m·B, K) cotangents: shared by every party (a
        party-stride-0 view of one (m·B, m·K) Θ), or per party for
        (q, m·B, K) ones."""
        cols = dom_block_cols(cots, m)
        return self._share(cols) if cots.dim() == 2 else cols

    def _bwd_doms_wide(self, rows, cots, m: int, denom: int):
        """(q, D, m, K) per-dominator slabs from the concatenated
        (q, m·B, D) row block and the (m·B, K) shared or (q, m·B, K)
        per-party cotangents: slab j is rows_jᵀ·cots_j/denom.  Always one
        backward launch with the block-diagonal (m·B, m·K) columns (the
        row block is read once for all m dominators); the port has no size
        route to a segment contraction."""
        g = self._bwd(rows, self._dom_cols(cots, m), denom)
        return g.view(*g.shape[:2], m, cots.shape[-1])

    def _bwd_doms(self, xb, theta, m: int, denom: int):
        """(q, dp, m) per-dominator BUM data gradients from the
        concatenated (q, m·B, dp) minibatch block and the (m·B,) shared or
        (q, m·B) per-party ϑ: column j is X_{b_j}ᵀϑ_j/denom
        (:meth:`_bwd_doms_wide` at K = 1)."""
        return self._bwd_doms_wide(xb, theta[..., None], m, denom)[..., 0]

    def _pipe(self, xcat, split: int, wcols, thcols, denom: int):
        """The pipelined step's one contraction: rows [0, split) of the
        party-stacked block ``xcat`` (q, split + Bf, dp) against Θ (the BUM
        application of round t) and rows [split, ...) against W (the
        forward of round t+1), in one split-batch fused launch.  Returns
        ``(z_next (q, Bf[, Mw]), g (q, dp[, Mθ]))``; rank-1 sides
        squeeze."""
        return ops.vfl_grad(xcat, wcols, thcols, mode="fused", split=split,
                            denom=denom)

    def _pipe_doms_wide(self, xcat, split: int, wcols, cots, m: int,
                        denom: int):
        """Pipelined per-dominator contraction: backward(t)'s m K-column
        slabs (block-diagonal, as in :meth:`_bwd_doms_wide`) beside
        forward(t+1)'s Mw columns ``wcols`` in one split launch — the
        sides' column counts differ (Mθ = m·K).  Returns
        ``(z_next (q, Bf[, Mw]), g (q, dp, m, K))``."""
        z, g = self._pipe(xcat, split, wcols, self._dom_cols(cots, m), denom)
        return z, g.view(*g.shape[:2], m, cots.shape[-1])

    def _pipe_doms(self, xcat, split: int, wq, theta, m: int, denom: int):
        """Pipelined multi-dominator linear contraction: the m ϑ columns
        beside the single iterate column (Mw = 1, Mθ = m).  Returns
        ``(z_next (q, m·B), gg (q, dp, m))``."""
        z, g = self._pipe_doms_wide(xcat, split, wq, theta[..., None], m,
                                    denom)
        return z, g[..., 0]

    def _share(self, theta):
        """The dominator's ϑ (B,) or (B, M), broadcast to every party: a
        party-stride-0 view, the stand-in for sending it to each party."""
        return theta.expand(self.qloc, *theta.shape)

    def _agg(self, z, gen: torch.Generator):
        """Masked secure aggregation of the party-stacked partials z
        (q, ...) over the party axis -> the aggregate (...).  A packed
        ``PartyMesh``: the two-level form (``secure_psum_hier``).  On a
        device mesh ``gen`` is the rank's ``PartyStreams`` and z its
        parties' partials: :meth:`_agg_dist`."""
        cfg = self.cfg
        if self._dist is not None:
            return self._agg_dist(z, gen)
        if cfg.secure == "off":
            return z.sum(0)
        if self._slots < self.q:
            return secure_psum_hier(z, gen, self._slots, mode=cfg.secure,
                                    mask_scale=cfg.mask_scale,
                                    schedule_faithful=cfg.schedule_faithful)
        if cfg.secure == "ring":
            return secure_psum_ring(z, gen, mask_scale=cfg.mask_scale)
        return secure_psum(z, gen, mask_scale=cfg.mask_scale,
                           schedule_faithful=cfg.schedule_faithful)

    def _agg_dist(self, z, streams: PartyStreams):
        """:meth:`_agg` over the model group: the rank's (qloc, ...)
        partials summed (``off``), masked with their own streams and
        aggregated across the slots (flat), or aggregated two-level
        (packed); the aggregate, on every rank."""
        cfg, grp = self.cfg, self._mgroup
        if cfg.secure == "off":
            return psum_dist(z.sum(0), grp)
        if self._slots < self.q:
            return secure_psum_hier_dist(
                z, streams, grp, mode=cfg.secure, mask_scale=cfg.mask_scale,
                schedule_faithful=cfg.schedule_faithful)
        if cfg.secure == "ring":
            return secure_psum_ring_dist(z[0], streams.own[0], streams.prev,
                                         grp, mask_scale=cfg.mask_scale)
        return secure_psum_dist(z[0], streams.own[0], grp,
                                mask_scale=cfg.mask_scale,
                                schedule_faithful=cfg.schedule_faithful)

    def _agg_members(self, z, gen: torch.Generator, alive, key=None):
        """Survivor-aware masked aggregation (the faulted epochs'
        Algorithm 1) over the parties whose ``alive`` (q,) flag is set: the
        masks cancel over the survivors.  ``two_tree`` always lowers to the
        masked-psum form here, ``schedule_faithful`` or not: a replay of a
        fixed tree schedule is not membership-safe (a crashed party is a
        hole in it), while mask cancellation does not depend on the
        schedule.  A packed ``PartyMesh``: the two-level membership form,
        each slot's any-alive flag its liveness across the slots.  On a
        device mesh: :meth:`_agg_members_dist`, ``key`` the step key of
        the ring's counter stream."""
        cfg = self.cfg
        if self._dist is not None:
            return self._agg_members_dist(z, gen, alive, key)
        if cfg.secure == "off":
            return (alive.view(-1, *([1] * (z.dim() - 1))) * z).sum(0)
        if self._slots < self.q:
            return secure_psum_hier_members(z, gen, alive, self._slots,
                                            mode=cfg.secure,
                                            mask_scale=cfg.mask_scale)
        if cfg.secure == "ring":
            return secure_psum_ring_members(z, gen, alive,
                                            mask_scale=cfg.mask_scale)
        return secure_psum_members(z, gen, alive, mask_scale=cfg.mask_scale)

    def _agg_members_dist(self, z, streams: PartyStreams, alive, key):
        """:meth:`_agg_members` over the model group, ``z`` and ``alive``
        the rank's (qloc, ...) and (qloc,) rows: the survivors' plain sum
        (``off``); flat, the rank's party masked from its own stream
        (``two_tree``) or from the counter stream on the step key ``key``
        at its rank among the survivors, the alive vector gathered over
        the ranks (``ring``); packed, the two-level membership form.
        Every rank enters every collective, a rank whose parties are all
        dead with zeros."""
        cfg, grp = self.cfg, self._mgroup
        if cfg.secure == "off":
            return psum_dist((alive.view(-1, *([1] * (z.dim() - 1))) * z)
                             .sum(0), grp)
        if self._slots < self.q:
            return secure_psum_hier_members_dist(
                z, streams, alive, grp, cfg.mask_scale, mode=cfg.secure,
                key=key)
        if cfg.secure == "ring":
            return secure_psum_ring_members_dist(
                z[0], key, gather_flags_dist(alive, grp), grp, cfg.mask_scale)
        return secure_psum_members_dist(z[0], streams.own[0], alive[0], grp,
                                        cfg.mask_scale)

    # -- running an epoch ----------------------------------------------------

    def _loop(self, name, idx, lr, mask_key, **carries) -> _StepLoop:
        """The step loop of epoch kind ``name`` at ``idx``'s shape, loaded
        with ``carries``, the schedule and ``lr``, its counter at 0, and
        the mask generator seeded from ``mask_key``."""
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        carries = {k: self._carry(v) for k, v in carries.items()}
        if idx.dim() != 2:
            raise ValueError(f"idx must be (steps, batch); got "
                             f"{tuple(idx.shape)}")
        key = (name, tuple(idx.shape))
        loop = self._loops.get(key)
        if loop is None:
            bufs = {k: torch.empty_like(v) for k, v in carries.items()}
            bufs["idx"] = torch.empty_like(idx)
            bufs["t"] = torch.zeros((1,), dtype=torch.int64,
                                    device=self.device)
            bufs["lr"] = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
            if self._dist is not None:
                bufs["key"] = torch.zeros((2,), dtype=torch.int64,
                                          device=self.device)
            loop = self._loops[key] = _StepLoop(bufs)
        b = loop.bufs
        for k, v in carries.items():
            b[k].copy_(v)
        b["idx"].copy_(idx)
        b["t"].zero_()
        b["lr"].fill_(float(lr))
        if "key" in b:              # filled in on the device, as lr is
            for i, w in enumerate(key_words(*mask_key, _TAG_STEPS)):
                b["key"][i].fill_(w)
        self._reseed(*mask_key, _TAG_STEPS)
        return loop

    def _carry(self, v) -> torch.Tensor:
        """A carry on the engine's device: float32, or int64 for integer
        values (delays, the global step).  A host int is filled in on the
        device: a host-to-device copy would synchronise."""
        if isinstance(v, (int, np.integer)):
            return torch.full((), int(v), dtype=torch.int64,
                              device=self.device)
        v = torch.as_tensor(v, device=self.device)
        return v.float() if v.is_floating_point() else v.long()

    # -- tracing (the reference's party programs and jaxpr probes) ----------

    @contextlib.contextmanager
    def tracing(self):
        """Within this context an epoch call records its kind's program
        (:meth:`party_program`) instead of running: its loop is loaded,
        nothing else changes, and it returns the loaded state."""
        self._local_only("tracing (the linter's party programs)")
        prev, self._tracing = self._tracing, True
        try:
            yield self
        finally:
            self._tracing = prev

    def party_program(self, name: str):
        """The recorded ``fx.GraphModule`` of epoch kind ``name`` (the
        reference's names: ``"sgd"``, ``"pipelined_sgd"``,
        ``"delayed2"``, ``"faulted_sgd2"``, ``"guarded_sgd2_1"``,
        ``"deep_sgd"``, ...); the epoch must have been called once under
        :meth:`tracing`."""
        if name not in self._programs:
            raise KeyError(f"no party program recorded for {name!r}; trace "
                           f"the epoch first (built: "
                           f"{sorted(self._programs)})")
        return self._programs[name]

    def party_consts(self):
        """The engine's tensors a step reads besides its loop buffers, as
        ``trace_program``'s ``consts``: the feature block (the party's
        private source) and the party-stacked masks and row offsets."""
        return ((self.xs, 0, True), (self.maskq, 0, False),
                (self.trainq, 0, False), (self._row0, 0, False))

    def _epoch(self, kind: str, loop: _StepLoop, body) -> None:
        """Run ``body()`` (which reads ``loop.bufs``), or, under
        :meth:`tracing`, record its trace as ``kind``'s program."""
        if not self._tracing:
            body()
            return
        saved = loop.bufs

        def fn(bufs):
            loop.bufs = bufs
            try:
                body()
            finally:
                loop.bufs = saved

        self._programs[kind] = trace_program(
            fn, saved, {k: _BUF_PARTY_DIM.get(k, 0) for k in saved},
            self.party_consts())

    def epoch_graph(self, kind: str, epoch, *args, **kw):
        """Trace one call of ``epoch`` and return ``kind``'s program."""
        with self.tracing():
            epoch(*args, **kw)
        return self.party_program(kind)

    def sgd_epoch_graph(self, wq, lr, idx, mask_key=(0,)):
        """The SGD epoch's program (``sgd_epoch_jaxpr``'s counterpart)."""
        return self.epoch_graph("sgd", self.sgd_epoch, wq, lr, idx, mask_key)

    def pipelined_sgd_epoch_graph(self, wq, lr, idx, mask_key=(0,)):
        """The pipelined SGD epoch's program: prologue, one step (one
        ``vfl_grad`` node), epilogue."""
        return self.epoch_graph("pipelined_sgd", self.pipelined_sgd_epoch,
                                wq, lr, idx, mask_key)

    def deep_sgd_epoch_graph(self, pq, lr, idx, mask_key=(0,)):
        """The deep SGD epoch's program (4 ``vfl_grad`` nodes a step)."""
        return self.epoch_graph("deep_sgd", self.deep_sgd_epoch, pq, lr, idx,
                                mask_key)

    def deep_pipelined_sgd_epoch_graph(self, pq, lr, idx, mask_key=(0,)):
        """The pipelined deep SGD epoch's program (1 node a step)."""
        return self.epoch_graph("deep_pipelined_sgd",
                                self.deep_pipelined_sgd_epoch, pq, lr, idx,
                                mask_key)

    def faulted_sgd_epoch_graph(self, wq, bufq, t0, delays, fwdq, bwdq,
                                extraq, lr, idx, tau, mask_key=(0,)):
        """The faulted SGD epoch's program."""
        return self.epoch_graph(f"faulted_sgd{tau}", self.faulted_sgd_epoch,
                                wq, bufq, t0, delays, fwdq, bwdq, extraq, lr,
                                idx, tau, mask_key)

    def guarded_sgd_epoch_graph(self, wq, bufq, t0, delays, fwdq, bwdq,
                                extraq, corruptq, lr, idx, tau,
                                mask_key=(0,), guard: bool = True):
        """The guarded SGD epoch's program."""
        return self.epoch_graph(f"guarded_sgd{tau}_{int(bool(guard))}",
                                self.guarded_sgd_epoch, wq, bufq, t0, delays,
                                fwdq, bwdq, extraq, corruptq, lr, idx, tau,
                                mask_key, guard=guard)

    def _run(self, loop: _StepLoop, step, steps=None) -> None:
        """Run ``step(loop.bufs)`` ``steps`` times (default once per row of
        the schedule): eagerly on the CPU and over gloo; on the card (over
        NCCL on a device mesh) the first step
        eagerly (it also builds what is made at first use: the kernel
        library, the trees' round indices), then replays of the step's
        CUDA graph, captured at the first epoch of this kind and shape.
        Under :meth:`tracing`, one step is traced and marked."""
        if steps is None:
            steps = loop.bufs["idx"].shape[0]
        if self._tracing:
            if steps:
                _mark_step(lambda: step(loop.bufs))
            return
        if not self._capturable:
            for _ in range(steps):
                step(loop.bufs)
            return
        if steps == 0:
            return
        step(loop.bufs)
        if steps == 1:
            return
        if loop.graph is None:
            loop.graph, loop.per_step = self._capture(
                lambda: step(loop.bufs))
        for _ in range(steps - 1):
            loop.graph.replay()
        _vg.KERNEL.add_launches(loop.per_step, steps - 1)

    def _capture(self, fn):
        """Capture ``fn``'s launches as a CUDA graph on a side stream
        (nothing runs); returns the graph and the kernel launches per
        replay.  The counters went up while ``fn`` was recorded and are
        set back: the graph's replays are counted as they are made."""
        before = dict(_vg.KERNEL.launches)
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators():
            graph.register_generator_state(gen)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                fn()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        per_step = {k: v - before[k]
                    for k, v in _vg.KERNEL.launches.items() if v != before[k]}
        _vg.KERNEL.add_launches(per_step, -1)
        return graph, per_step

    def _gather(self, ib):
        """The party-stacked feature block (q, R, dp) of the R ids ``ib``:
        one gather of q·R whole rows (``xs.index_select(1, ib)`` would run
        as an elementwise gather, several times slower on the card;
        PERF.md)."""
        rows = (self._row0 + ib).view(-1)
        return self.xs.view(-1, self.dp).index_select(0, rows) \
            .view(self.qloc, -1, self.dp)

    def _row(self, b):
        """The row of the schedule at the device counter, which moves on."""
        ib = b["idx"].index_select(0, b["t"]).squeeze(0)
        b["t"].add_(1)
        return ib

    def _batch(self, b):
        """This step's minibatch: the row of the schedule at the device
        counter (which moves on), its party-stacked feature block
        (q, B, dp) and its labels."""
        ib = self._row(b)
        return ib, self._gather(ib), self.y.index_select(0, ib)

    def _pair(self, b):
        """A pipelined step's rows: the schedule rows t (at the device
        counter, which moves on) and t+1 gathered together as one
        (q, 2R, dp) block — round t's backward rows, then round t+1's
        forward rows — with round t's ids and labels."""
        ii = b["idx"].index_select(0, b["t"] + self._pair_rows).view(-1)
        b["t"].add_(1)
        ib = ii[: ii.shape[0] // 2]
        return ib, self._gather(ii), self.y.index_select(0, ib)

    # -- full-dataset passes (SVRG's snapshot gradient, SAGA's table) --------

    def full_gradient(self, wq, mask_key=(0,)):
        """∇f(w) of every party's block, (q, dp): one masked aggregation
        and one backward pass over all n samples."""
        prob = self.problem
        gen = self._reseed(*mask_key, _TAG_FULL)
        z = self._fwd(self.xs, wq)                                # (q, n)
        theta = prob.theta(self._agg(z, gen), self.y)
        return self._bwd(self.xs, self._share(theta), self.n) \
            + prob.lam * prob.reg_grad(wq)

    def saga_init(self, wq, mask_key=(0,)):
        """ϑ̃ table (q, n) + per-party running average (q, dp): Alg. 6
        step 2's pass over all n samples."""
        prob = self.problem
        gen = self._reseed(*mask_key, _TAG_SAGA_INIT)
        z = self._fwd(self.xs, wq)
        theta = prob.theta(self._agg(z, gen), self.y)
        avgq = self._bwd(self.xs, self._share(theta), self.n)
        return theta.repeat(self.qloc, 1), avgq

    # -- the epochs (Algorithms 2–7) ------------------------------------------
    #
    # Every epoch runs its steps through _run_epoch.  Single-dominator: a
    # step takes one (B) row of the schedule.  Multi-dominator (m =
    # layout.m active parties per round): one (m·B) row, the m dominators'
    # concatenated minibatches, through one forward, one masked aggregation
    # of all m partial sets and one backward whose Θ is block-diagonal (its
    # M = m columns are the m BUM gradients) or, for SVRG, the M = 2 pair
    # summed over all m·B rows.  Pipelined (τ = 1): round t's BUM
    # application uses the forward read taken before round t−1's update,
    # so backward(t) and forward(t+1) share one split-batch launch.  An
    # algorithm's _Parts are shared by its fresh steps, its interior
    # pipelined steps and its pipelined epilogue.

    def _sgd_parts(self, multi: bool) -> _Parts:
        prob, m = self.problem, self.layout.m

        def theta(b, agg, ib, yb):
            th = prob.theta(agg, yb)
            if multi:
                return th, ib.shape[0] // m, None
            return self._share(th), ib.shape[0], None

        def apply(b, g, _):
            wq = b["wq"]
            if multi:
                g = g.sum(-1) + m * prob.lam * prob.reg_grad(wq)
            else:
                g = g + prob.lam * prob.reg_grad(wq)
            wq.sub_(b["lr"] * self.maskq * g)

        return _Parts(lambda b: b["wq"], theta, apply, multi)

    def _svrg_parts(self, multi: bool) -> _Parts:
        prob, m = self.problem, self.layout.m

        def theta(b, agg, ib, yb):                 # ϑ₁, ϑ₀ as (R, 2)
            th = prob.theta(agg, yb[:, None])
            return self._share(th), ib.shape[0] // (m if multi else 1), None

        def apply(b, gg, _):
            wq, wsq = b["wq"], b["wsq"]
            if multi:
                th_reg = prob.lam * (prob.reg_grad(wq) - prob.reg_grad(wsq))
                v = gg[..., 0] - gg[..., 1] + m * (th_reg + b["muq"])
            else:
                v = (gg[..., 0] + prob.lam * prob.reg_grad(wq)) \
                    - (gg[..., 1] + prob.lam * prob.reg_grad(wsq)) + b["muq"]
            wq.sub_(b["lr"] * self.maskq * v)

        return _Parts(lambda b: torch.stack([b["wq"], b["wsq"]], dim=2),
                      theta, apply, False)

    def _saga_parts(self, multi: bool) -> _Parts:
        prob, m = self.problem, self.layout.m

        def theta(b, agg, ib, yb):
            th_new = prob.theta(agg, yb)
            # each party reads its own copy of the table: a per-party Θ
            dth = th_new - b["tabq"].index_select(1, ib)          # (q, R)
            return dth, 1, (th_new, ib)

        def apply(b, raw, aux):
            th_new, ib = aux
            wq, tab, avg = b["wq"], b["tabq"], b["avgq"]
            if multi:
                raw = raw.sum(-1)
                v = raw / (ib.shape[0] // m) + m * avg \
                    + m * prob.lam * prob.reg_grad(wq)
            else:
                v = raw / ib.shape[0] + avg + prob.lam * prob.reg_grad(wq)
            wq.sub_(b["lr"] * self.maskq * v)
            avg.add_(raw / self.n)
            tab[:, ib] = th_new[last_occurrence(ib)]

        return _Parts(lambda b: b["wq"], theta, apply, multi)

    def _delayed_parts(self, multi: bool) -> _Parts:
        """Stale-gradient SGD (``core.staleness``): SGD's forward columns
        and ϑ; the update writes the step's gradient, regulariser
        included, into ring slot t mod (τ+1) of ``bufq`` (q, τ+1, dp[, m]),
        reads each party's (each (party, dominator) pair's) slot
        max(t − d, 0) mod (τ+1) and applies the masked stale gradient
        (multi: the sum of the m stale columns, each carrying the
        regulariser of its own step's iterate).  The global step t is the
        device counter ``step``; the slots are device indices, so a
        replay of the captured step moves them."""
        prob = self.problem

        def apply(b, g, _):
            wq, buf, t = b["wq"], b["bufq"], b["step"]
            reg = prob.lam * prob.reg_grad(wq)
            g = g + (reg[..., None] if multi else reg)
            ring = buf.shape[1]
            buf.index_copy_(1, (t % ring).view(1), g.unsqueeze(1))
            eff = (t - b["delays"]).clamp_min(0) % ring     # (q[, m])
            stale = buf.gather(1, eff[:, None, None].expand_as(
                g.unsqueeze(1))).squeeze(1)
            wq.sub_(b["lr"] * self.maskq * (stale.sum(-1) if multi
                                            else stale))
            t.add_(1)

        return self._sgd_parts(multi)._replace(apply=apply)

    def _step_bwd(self, parts: _Parts, xb, th, denom: int):
        """The backward of a fresh step or of a pipelined epilogue."""
        if parts.doms:
            return self._bwd_doms(xb, th, self.layout.m, denom)
        return self._bwd(xb, th, denom)

    def _fresh_step(self, b, parts: _Parts):
        """A step of a fresh (not pipelined) epoch: forward, aggregation
        and backward of one schedule row, all at the current iterate."""
        ib, xb, yb = self._batch(b)
        agg = self._agg(self._fwd(xb, parts.cols(b)), self._gen)
        th, denom, aux = parts.theta(b, agg, ib, yb)
        parts.apply(b, self._step_bwd(parts, xb, th, denom), aux)

    def _sliced_step(self, b, parts: _Parts):
        """A fresh SGD or SVRG step over a ``PartyMesh`` data axis: the
        minibatch splits into ``data_shards`` disjoint contiguous slices
        (shard s holds rows [s·B/S, (s+1)·B/S)), each slice's partials
        are aggregated with a mask draw of their own (the reference's
        ``_dkey``: no stream serves two slices) and give that slice's ϑ.
        The data shards share each party's trust domain, so their
        gradients meet unmasked: one backward launch over the whole batch
        is the slices' XᵀΘ summed, each denominated by the full batch B.
        The forward is one launch too (a row's partial is its own).
        On a device mesh: :meth:`_sliced_step_dist`."""
        if self._dist is not None:
            self._sliced_step_dist(b, parts)
            return
        ib, xb, yb = self._batch(b)
        z = self._fwd(xb, parts.cols(b))
        agg = torch.cat([self._agg(zs, self._gen)
                         for zs in z.chunk(self._ddp, 1)], 0)
        th, denom, aux = parts.theta(b, agg, ib, yb)
        parts.apply(b, self._step_bwd(parts, xb, th, denom), aux)

    def _sliced_step_dist(self, b, parts: _Parts):
        """:meth:`_sliced_step` on a device mesh: this rank takes its data
        shard's slice of the minibatch, aggregates its partials over the
        model group with the shard's own mask streams (seeded in
        :meth:`_run_epoch`), and sums the backward, denominated by the
        whole batch, over the data group."""
        ib = self._row(b)
        bs = ib.shape[0] // self._ddp
        ibs = ib.narrow(0, self._didx * bs, bs)
        xb = self._gather(ibs)
        agg = self._agg(self._fwd(xb, parts.cols(b)), self._gen)
        th, denom, aux = parts.theta(b, agg, ibs, self.y.index_select(0, ibs))
        parts.apply(b, self._dsum(self._step_bwd(parts, xb, th,
                                                 denom * self._ddp)), aux)

    def _pipe_step(self, b, parts: _Parts):
        """An interior pipelined step: round t's ϑ from the carried
        aggregate (read before this step overwrites it), then exactly one
        split-batch launch — round t's backward and round t+1's forward at
        the pre-update iterate — then round t+1's aggregation and round
        t's update."""
        ib, xcat, yb = self._pair(b)
        th, denom, aux = parts.theta(b, b["agg"], ib, yb)
        if parts.doms:
            z, g = self._pipe_doms(xcat, ib.shape[0], parts.cols(b), th,
                                   self.layout.m, denom)
        else:
            z, g = self._pipe(xcat, ib.shape[0], parts.cols(b), th, denom)
        b["agg"].copy_(self._agg(z, self._gen))
        parts.apply(b, g, aux)

    def _pipelined(self, loop: _StepLoop, parts: _Parts) -> None:
        """A pipelined epoch: the forward prologue of schedule row 0 (its
        aggregate into the loop's carried buffer), ``steps − 1`` interior
        steps, and the backward epilogue of the last row, which uses the
        forward read taken before the previous update."""
        b = loop.bufs
        agg0 = self._agg(self._fwd(self._gather(b["idx"][0]), parts.cols(b)),
                         self._gen)
        if "agg" not in b:
            b["agg"] = torch.empty_like(agg0)
        b["agg"].copy_(agg0)
        self._run(loop, lambda bufs: self._pipe_step(bufs, parts),
                  b["idx"].shape[0] - 1)
        ib = b["idx"][-1]
        th, denom, aux = parts.theta(b, b["agg"], ib,
                                     self.y.index_select(0, ib))
        parts.apply(b, self._step_bwd(parts, self._gather(ib), th, denom),
                    aux)

    def _run_epoch(self, algo: str, multi: bool, pipelined: bool, idx, lr,
                   mask_key, tag="", parts=None, step_fn=None, kind=None,
                   **carries):
        """Run one epoch of ``algo`` in the given form from ``carries``;
        returns the loop's buffers.  ``tag`` completes the loop's name
        where a carry's shape is not fixed by the engine (the ring's τ) or
        where ``parts`` and ``step_fn`` replace the algorithm's parts and
        the fresh step (the faulted and guarded epochs); ``kind`` names
        the program :meth:`tracing` records (default: the loop's name)."""
        name = ("multi_" if multi else "") \
            + ("pipelined_" if pipelined else "") + algo + tag
        if parts is None:
            parts = getattr(self, f"_{algo}_parts")(multi)
            if self._ddp > 1 and algo in ("sgd", "svrg") \
                    and not (multi or pipelined):
                batch = np.shape(idx)[1]
                if batch % self._ddp != 0:
                    raise ValueError(f"batch={batch} must divide "
                                     f"data_shards={self._ddp}")
                step_fn = self._sliced_step
                if self._dist is not None:     # the shard's own streams
                    mask_key = (*mask_key, _TAG_DATA + self._didx)
        loop = self._loop(name, idx, lr, mask_key, **carries)
        if pipelined:
            self._epoch(kind or name, loop,
                        lambda: self._pipelined(loop, parts))
        else:
            step_fn = step_fn or self._fresh_step
            self._epoch(kind or name, loop, lambda: self._run(
                loop, lambda b: step_fn(b, parts)))
        return loop.bufs

    def _sgd(self, multi, pipelined, wq, lr, idx, mask_key):
        return self._run_epoch("sgd", multi, pipelined, idx, lr, mask_key,
                               wq=wq)["wq"].clone()

    def _svrg(self, multi, pipelined, wq, wq_snap, muq, lr, idx, mask_key):
        return self._run_epoch("svrg", multi, pipelined, idx, lr, mask_key,
                               wq=wq, wsq=wq_snap, muq=muq)["wq"].clone()

    def _saga(self, multi, pipelined, wq, tabq, avgq, lr, idx, mask_key):
        b = self._run_epoch("saga", multi, pipelined, idx, lr, mask_key,
                            wq=wq, tabq=tabq, avgq=avgq)
        return b["wq"].clone(), b["tabq"].clone(), b["avgq"].clone()

    def _delayed(self, multi, pipelined, wq, bufq, t0, delays, lr, idx, tau,
                 mask_key):
        self._check_rows("bufq", bufq)
        self._check_rows("delays", delays)
        if bufq.shape[1] != tau + 1:
            raise ValueError(f"bufq holds {bufq.shape[1]} ring slots; "
                             f"tau={tau} needs {tau + 1}")
        b = self._run_epoch("delayed", multi, pipelined, idx, lr, mask_key,
                            tag=str(tau), wq=wq, bufq=bufq, delays=delays,
                            step=t0)
        return b["wq"].clone(), b["bufq"].clone(), b["step"].clone()

    def sgd_epoch(self, wq, lr, idx, mask_key=(0,)):
        """One VFB²-SGD epoch over the schedule ``idx`` (steps, batch);
        returns the new (q, dp) iterate."""
        return self._sgd(False, False, wq, lr, idx, mask_key)

    def svrg_epoch(self, wq, wq_snap, muq, lr, idx, mask_key=(0,)):
        """Inner loop of VFB²-SVRG; the current iterate and the snapshot
        ride the same kernel launches (M = 2)."""
        return self._svrg(False, False, wq, wq_snap, muq, lr, idx, mask_key)

    def saga_epoch(self, wq, tabq, avgq, lr, idx, mask_key=(0,)):
        """One VFB²-SAGA epoch; returns (wq, tabq, avgq).  On duplicate
        indices in a minibatch the last write to the table wins."""
        return self._saga(False, False, wq, tabq, avgq, lr, idx, mask_key)

    def multi_sgd_epoch(self, wq, lr, idx, mask_key=(0,)):
        """VFB²-SGD with all m = layout.m dominators updating at once, over
        the (steps, m·B) schedule ``idx``: one forward over the
        concatenated (m·B) block, one aggregation of all m partial sets,
        one M = m block-diagonal backward.  Returns the new (q, dp)
        iterate."""
        return self._sgd(True, False, wq, lr, idx, mask_key)

    def multi_svrg_epoch(self, wq, wq_snap, muq, lr, idx, mask_key=(0,)):
        """Multi-dominator VFB²-SVRG inner loop: the m dominators' rows
        ride one M = 2 forward and backward (iterate and snapshot)."""
        return self._svrg(True, False, wq, wq_snap, muq, lr, idx, mask_key)

    def multi_saga_epoch(self, wq, tabq, avgq, lr, idx, mask_key=(0,)):
        """Multi-dominator VFB²-SAGA: the m dominators' Δϑ are the M = m
        columns of one backward; the table takes all m·B writes of a step
        (the last occurrence of a duplicate id wins).  Returns (wq, tabq,
        avgq)."""
        return self._saga(True, False, wq, tabq, avgq, lr, idx, mask_key)

    def pipelined_sgd_epoch(self, wq, lr, idx, mask_key=(0,)):
        """Pipelined VFB²-SGD over the (steps, B) schedule ``idx``: a
        forward prologue, ``steps − 1`` split-batch steps, a backward
        epilogue.  Returns the new (q, dp) iterate."""
        return self._sgd(False, True, wq, lr, idx, mask_key)

    def pipelined_svrg_epoch(self, wq, wq_snap, muq, lr, idx,
                             mask_key=(0,)):
        """Pipelined VFB²-SVRG inner loop: iterate and snapshot ride one
        M = 2 split-batch launch (ϑ₁ on the stale read; the snapshot is
        constant, so ϑ₀ is delay-free)."""
        return self._svrg(False, True, wq, wq_snap, muq, lr, idx, mask_key)

    def pipelined_saga_epoch(self, wq, tabq, avgq, lr, idx, mask_key=(0,)):
        """Pipelined VFB²-SAGA: each party's Δϑ enters the split-batch
        launch at application time (per-party Θ, denom 1); only the
        forward read of the iterate is one step stale."""
        return self._saga(False, True, wq, tabq, avgq, lr, idx, mask_key)

    def multi_pipelined_sgd_epoch(self, wq, lr, idx, mask_key=(0,)):
        """Pipelined multi-dominator VFB²-SGD over the (steps, m·B)
        schedule: the m dominators' block-diagonal Θ and the next round's
        forward ride one split-batch launch with Mw = 1, Mθ = m."""
        return self._sgd(True, True, wq, lr, idx, mask_key)

    def multi_pipelined_svrg_epoch(self, wq, wq_snap, muq, lr, idx,
                                   mask_key=(0,)):
        """Pipelined multi-dominator VFB²-SVRG: the m·B rows share the
        M = 2 columns of one split-batch launch per step."""
        return self._svrg(True, True, wq, wq_snap, muq, lr, idx, mask_key)

    def multi_pipelined_saga_epoch(self, wq, tabq, avgq, lr, idx,
                                   mask_key=(0,)):
        """Pipelined multi-dominator VFB²-SAGA: per-party, per-dominator Δϑ
        columns beside the single forward column, one launch per step."""
        return self._saga(True, True, wq, tabq, avgq, lr, idx, mask_key)

    # -- bounded-delay (τ) epochs (core.staleness semantics) -----------------
    #
    # Party ℓ applies at global step t the BUM gradient of step
    # t − d_ℓ (clamped at the first step), from a per-party ring of the
    # last τ+1 gradients: ``bufq`` (q, τ+1, dp) with ``delays`` (q,), or
    # per (party, dominator) for the multi-dominator forms, (q, τ+1, dp, m)
    # with (q, m).  ``t0`` is the global step at the epoch's start (an int
    # or a device int tensor); each epoch returns ``(wq, bufq, t0 +
    # steps)``, the counter as a 0-d int64 device tensor, so that the ring
    # and the counter carry into the next epoch.  On a device mesh
    # ``bufq`` and ``delays`` are the rank's rows (made at qloc rows, or
    # :meth:`local` of whole ones) and the counter is the same on every
    # rank.

    def delayed_sgd_epoch(self, wq, bufq, t0, delays, lr, idx, tau,
                          mask_key=(0,)):
        """Stale-gradient VFB²-SGD over the (steps, B) schedule ``idx``."""
        return self._delayed(False, False, wq, bufq, t0, delays, lr, idx,
                             tau, mask_key)

    def multi_delayed_sgd_epoch(self, wq, bufq, t0, delays, lr, idx, tau,
                                mask_key=(0,)):
        """Multi-dominator stale-gradient VFB²-SGD over the (steps, m·B)
        schedule: dominator j's gradient column ages in ring column j
        under party ℓ's delay d_{ℓ,j}."""
        return self._delayed(True, False, wq, bufq, t0, delays, lr, idx,
                             tau, mask_key)

    def pipelined_delayed_sgd_epoch(self, wq, bufq, t0, delays, lr, idx,
                                    tau, mask_key=(0,)):
        """Pipelined stale-gradient VFB²-SGD: each step's stale-read (τ = 1)
        gradient enters the ring (written by every interior step and by
        the epilogue, never by the prologue)."""
        return self._delayed(False, True, wq, bufq, t0, delays, lr, idx,
                             tau, mask_key)

    def multi_pipelined_delayed_sgd_epoch(self, wq, bufq, t0, delays, lr,
                                          idx, tau, mask_key=(0,)):
        """Pipelined multi-dominator stale-gradient VFB²-SGD."""
        return self._delayed(True, True, wq, bufq, t0, delays, lr, idx, tau,
                             mask_key)

    # -- faulted and guarded epochs (core.faults semantics) -------------------
    #
    # The bounded-delay single-dominator epochs with a fault trace's
    # per-step channels, read inside the captured step at the device
    # counter as the schedule is: the loop buffer ``chan`` (4, q, steps)
    # holds each party's forward liveness, backward liveness, corrupt code
    # and base delay + straggle extra.  A step's forward partials enter the
    # survivor-aware aggregation (``_agg_members``) under the forward
    # liveness; the direction (SGD's gradient, SVRG's v, SAGA's v, each
    # with its regulariser) enters ring slot t mod (τ+1) only where the
    # party received ϑ (a gated write: a crashed or cut-off party writes
    # nothing), the read slot is max(t − (d + e), 0) mod (τ+1) in int64,
    # and the update is gated by the backward liveness too.  SAGA keeps
    # the replicated ϑ̃ table fresh at every step and gates the private
    # average.  The guarded epochs first corrupt each party's partial by
    # its code (``faults.apply_corruption``) and take a finiteness verdict
    # per party; ``guard=True`` quarantines a non-finite party (its
    # partial zeroed by ``where``, its forward liveness cleared for the
    # step), and each step writes its health columns (finite, alive, max
    # |z|, max |v|) into the loop's (4, q, steps) buffer at the step's
    # index.  No host read anywhere: on the card the whole epoch is an
    # eager step and replays of one graph.

    def _faulted_parts(self, algo: str) -> _Parts:
        """``algo``'s forward columns and ϑ, with the faulted update as
        ``apply(b, g, (aux, bl, de))``: the gated ring write and read, the
        gated update (and SAGA's table and gated average); returns the
        direction, for the telemetry."""
        prob = self.problem

        def direction(b, g, aux):
            reg = prob.lam * prob.reg_grad(b["wq"])
            if algo == "svrg":
                return (g[..., 0] + reg) \
                    - (g[..., 1] + prob.lam * prob.reg_grad(b["wsq"])) \
                    + b["muq"]
            if algo == "saga":
                return g / aux[1].shape[0] + b["avgq"] + reg
            return g + reg

        def apply(b, g, aux):
            aux, bl, de = aux
            v = direction(b, g, aux)
            buf, t = b["bufq"], b["step"]
            ring = buf.shape[1]
            slot = (t % ring).view(1)
            bl = bl[:, None]
            buf.index_copy_(1, slot, torch.where(
                bl[..., None] > 0, v.unsqueeze(1), buf.index_select(1, slot)))
            eff = (t - de).clamp_min(0) % ring                   # (q,)
            stale = buf.gather(1, eff[:, None, None].expand(
                -1, 1, buf.shape[2])).squeeze(1)
            b["wq"].sub_(b["lr"] * bl * self.maskq * stale)
            if algo == "saga":
                th_new, ib = aux
                b["avgq"].add_(bl * g / self.n)     # private: frozen while out
                b["tabq"][:, ib] = th_new[last_occurrence(ib)]
            t.add_(1)
            return v

        return getattr(self, f"_{algo}_parts")(False)._replace(apply=apply)

    def _fault_column(self, b):
        """The step's fault channels (forward liveness, backward liveness,
        corrupt code, delay + straggle), each (q,), and its schedule row,
        at the device counter ``t``."""
        t = b["t"]
        return b["chan"].index_select(2, t).squeeze(2), \
            b["idx"].index_select(0, t).squeeze(0)

    def _step_key(self, b):
        """The ring's step key on a device mesh: the loop's key words and
        the step counter ``t``, (3,) int64 on the device (None on one
        device)."""
        return torch.cat([b["key"], b["t"]]) if "key" in b else None

    def _guard_fwd(self, z, code, live, guard: bool):
        """Corrupt each party's partial (qloc, ...) by its code, take the
        per-party finiteness verdict and, under ``guard``, quarantine: a
        non-finite partial is zeroed by ``where`` (0·NaN is NaN) and its
        party leaves the step's forward alive set.  Returns (the shipped
        partials, the liveness, the healthy flags, max |·| of each
        corrupted partial)."""
        shape = (self.qloc,) + (1,) * (z.dim() - 1)
        z = apply_corruption(z, code.view(shape))
        healthy = torch.isfinite(z).flatten(1).all(1).float()
        pnorm = z.abs().flatten(1).amax(1)
        if guard:
            live = live * healthy
            z = torch.where(healthy.view(shape) > 0, z, 0.0)
        return z, live, healthy, pnorm

    def _faulted_step(self, b, parts: _Parts, guard):
        """One faulted (``guard`` None) or guarded step: the schedule's row
        and the channels' column at the device counter ``t``, one forward
        and one backward launch, the survivor aggregation, the gated ring
        and update, and (guarded) the step's health columns at ``t``."""
        ch, ib = self._fault_column(b)
        xb = self._gather(ib)
        z = self._fwd(xb, parts.cols(b))
        live = ch[0]
        if guard is not None:
            z, live, healthy, pnorm = self._guard_fwd(z, ch[2], live, guard)
        agg = self._agg_members(z, self._gen, live, self._step_key(b))
        th, denom, aux = parts.theta(b, agg, ib, self.y.index_select(0, ib))
        v = parts.apply(b, self._bwd(xb, th, denom),
                        (aux, ch[1], ch[3].long()))
        if guard is not None:
            b["health"].index_copy_(2, b["t"], torch.stack(
                [healthy, live, pnorm, v.abs().amax(1)]).unsqueeze(2))
        b["t"].add_(1)

    def _fault_channels(self, delays, fwdq, bwdq, extraq, corruptq,
                        steps: int, guard, carries):
        """Stack an epoch's fault channels into the loop buffer ``chan``
        (4, qloc, steps) and, for a guarded epoch, add the zeroed health
        buffer to ``carries``."""
        self._check_rows("delays", delays)
        chan = torch.stack(torch.broadcast_tensors(*(
            self._carry(a).float() for a in (
                fwdq, bwdq, corruptq,
                self._carry(delays)[:, None] + self._carry(extraq)))))
        if chan.shape[1:] != (self.qloc, steps):
            raise ValueError(f"fault channels {tuple(chan.shape[1:])} != "
                             f"(party rows, steps) = ({self.qloc}, {steps})")
        carries["chan"] = chan
        if guard is not None:
            carries["health"] = torch.zeros_like(chan)

    def _faulted(self, algo, guard, delays, fwdq, bwdq, extraq, corruptq,
                 lr, idx, tau, mask_key, **carries):
        """Run one faulted (``guard`` None) or guarded epoch of ``algo``;
        returns the state, the counter as a 0-d int64 device tensor, and
        (guarded) the epoch's ``HealthStats`` of (qloc, steps) device
        tensors."""
        self._check_rows("bufq", carries["bufq"])
        if carries["bufq"].shape[1] != tau + 1:
            raise ValueError(f"bufq holds {carries['bufq'].shape[1]} ring "
                             f"slots; tau={tau} needs {tau + 1}")
        self._fault_channels(delays, fwdq, bwdq, extraq, corruptq, len(idx),
                             guard, carries)
        tag = f"_faulted{tau}" if guard is None \
            else f"_guarded{tau}_{int(bool(guard))}"
        kind = f"faulted_{algo}{tau}" if guard is None \
            else f"guarded_{algo}{tau}_{int(bool(guard))}"
        b = self._run_epoch(algo, False, False, idx, lr, mask_key, tag=tag,
                            kind=kind, parts=self._faulted_parts(algo),
                            step_fn=lambda bb, parts: self._faulted_step(
                                bb, parts, guard), **carries)
        out = ("wq", "tabq", "avgq") if algo == "saga" else ("wq",)
        out = tuple(b[k].clone() for k in out + ("bufq", "step"))
        if guard is None:
            return out
        return out + (HealthStats(*b["health"].clone()),)

    def faulted_sgd_epoch(self, wq, bufq, t0, delays, fwdq, bwdq, extraq, lr,
                          idx, tau, mask_key=(0,)):
        """Fault-trace VFB²-SGD over the (steps, B) schedule ``idx``:
        ``fwdq``/``bwdq`` (q, steps) 0/1 forward and backward liveness,
        ``extraq`` (q, steps) straggle's delay added to ``delays`` (q,).  A
        party with ``bwd = 0`` writes nothing into its ring and applies
        nothing; on rejoin its ring replays its last pre-crash gradients.
        Returns ``(wq, bufq, t0 + steps)``; ``faults.faulted_sgd_epoch``
        is the oracle."""
        return self._faulted("sgd", None, delays, fwdq, bwdq, extraq, 0, lr,
                             idx, tau, mask_key, wq=wq, bufq=bufq, step=t0)

    def faulted_svrg_epoch(self, wq, wq_snap, muq, bufq, t0, delays, fwdq,
                           bwdq, extraq, lr, idx, tau, mask_key=(0,)):
        """Fault-trace VFB²-SVRG inner loop: both forward columns (iterate
        and snapshot) are survivor aggregates; v = g(w) − g(w̃) + μ̃ ages in
        the gated ring.  Returns ``(wq, bufq, t0 + steps)``."""
        return self._faulted("svrg", None, delays, fwdq, bwdq, extraq, 0,
                             lr, idx, tau, mask_key, wq=wq, wsq=wq_snap,
                             muq=muq, bufq=bufq, step=t0)

    def faulted_saga_epoch(self, wq, tabq, avgq, bufq, t0, delays, fwdq,
                           bwdq, extraq, lr, idx, tau, mask_key=(0,)):
        """Fault-trace VFB²-SAGA: the replicated ϑ̃ table stays fresh at
        every step (the last occurrence of a duplicate id wins), the
        party-private average freezes while the party is out.  Returns
        ``(wq, tabq, avgq, bufq, t0 + steps)``."""
        return self._faulted("saga", None, delays, fwdq, bwdq, extraq, 0,
                             lr, idx, tau, mask_key, wq=wq, tabq=tabq,
                             avgq=avgq, bufq=bufq, step=t0)

    def guarded_sgd_epoch(self, wq, bufq, t0, delays, fwdq, bwdq, extraq,
                          corruptq, lr, idx, tau, mask_key=(0,),
                          guard: bool = True):
        """Guarded VFB²-SGD: the faulted epoch with corrupt-value injection
        (``corruptq`` (q, steps) codes), the finiteness quarantine
        (``guard=True``) and the health telemetry.  Returns ``(wq, bufq,
        t0 + steps, HealthStats)``; ``faults.guarded_sgd_epoch`` is the
        oracle."""
        return self._faulted("sgd", guard, delays, fwdq, bwdq, extraq,
                             corruptq, lr, idx, tau, mask_key, wq=wq,
                             bufq=bufq, step=t0)

    def guarded_svrg_epoch(self, wq, wq_snap, muq, bufq, t0, delays, fwdq,
                           bwdq, extraq, corruptq, lr, idx, tau,
                           mask_key=(0,), guard: bool = True):
        """Guarded VFB²-SVRG inner loop: a party's message is both partial
        columns; one code corrupts both and the verdict covers both."""
        return self._faulted("svrg", guard, delays, fwdq, bwdq, extraq,
                             corruptq, lr, idx, tau, mask_key, wq=wq,
                             wsq=wq_snap, muq=muq, bufq=bufq, step=t0)

    def guarded_saga_epoch(self, wq, tabq, avgq, bufq, t0, delays, fwdq,
                           bwdq, extraq, corruptq, lr, idx, tau,
                           mask_key=(0,), guard: bool = True):
        """Guarded VFB²-SAGA: the faulted epoch's freshness split with the
        corrupt channel on the forward partial.  Returns ``(wq, tabq,
        avgq, bufq, t0 + steps, HealthStats)``."""
        return self._faulted("saga", guard, delays, fwdq, bwdq, extraq,
                             corruptq, lr, idx, tau, mask_key, wq=wq,
                             tabq=tabq, avgq=avgq, bufq=bufq, step=t0)

    # -- deep VFB² epochs (party-local two-layer encoders) ---------------------
    #
    # Party ℓ holds w1 (dp, hidden), b1 (hidden,) and w2 (hidden, d_rep);
    # the head (d_rep,) is replicated over the party axis (the stand-in for
    # the dominator broadcasting ϑ_z) and takes the same update in every
    # row.  A fresh step: layer 1's and layer 2's forward through the
    # kernel (hidden and d_rep as M), one masked aggregation of the
    # (q, R, d_rep) partials, ϑ_z = ϑ_logit·head shared by every party, and
    # the Jacobian-transpose contractions hᵀϑ_z and xᵀ∂u through the kernel:
    # 4 launches.  SVRG runs the iterate (side "") and the snapshot (side
    # "s") together: one layer-1 forward against [W1 | W1ˢ] and one
    # backward against [∂u₁ | ∂u₀] (M = 2·hidden), two layer-2 forwards and
    # backwards, one aggregation of both partial sets: 6 launches.  A
    # pipelined interior step is one split-batch launch, round t's xᵀ∂u
    # beside round t+1's layer-1 forward at the pre-update params; its
    # layer 2 is plain batched matmuls, as in the reference, and its
    # activations ``h``/``hs`` and aggregate ``agg`` ride the loop's
    # buffers.  Every leaf carries mdom·λ∇g(·) (the m dominators' updates
    # summed in the multi-dominator forms); SVRG's μ leaves are ``mw1``,
    # ``mb1``, ``mw2``, ``mhead``.

    def _deep_cols(self, b, sides):
        """Layer 1's forward columns: W1, or [W1 | W1ˢ] for SVRG."""
        if len(sides) == 1:
            return b["w1"]
        return torch.cat([b["w1" + s] for s in sides], 2)

    def _deep_acts(self, b, u, sides, kernel: bool, agg=None):
        """Each side's activations h (q, R, hidden) from layer 1's forward
        ``u`` and the masked aggregate (R, sides·d_rep) of layer 2's
        partials, through the kernel or (pipelined) a plain matmul.
        ``agg`` replaces the plain masked aggregation of the party-stacked
        (q, R, sides·d_rep) partials (the faulted epochs')."""
        hid = b["w1"].shape[2]
        hs = [torch.tanh(u[..., i * hid:(i + 1) * hid] + b["b1" + s][:, None])
              for i, s in enumerate(sides)]
        layer2 = self._fwd if kernel else torch.matmul
        parts = [layer2(h, b["w2" + s]) for h, s in zip(hs, sides)]
        z = parts[0] if len(parts) == 1 else torch.cat(parts, 2)
        return hs, (self._agg(z, self._gen) if agg is None else agg(z))

    def _deep_tail(self, h, agg, yb, w2, head, mdom: int, kernel: bool,
                   doms: bool = False):
        """One side's application-time data gradients from its activations
        h and aggregate ``agg`` (R, d_rep): ϑ_logit at the dominator, ϑ_z
        shared by every party, each party's Jacobian transpose.  Returns
        (∂u (q, R, hidden), g_b1, g_w2, g_head) without the regulariser;
        hᵀϑ_z through the kernel or a plain batched matmul.  ``doms``
        keeps the mdom dominators' g_b1 (q, m, hidden) and g_w2
        (q, hidden, m, d_rep) apart."""
        hd = head[0]
        th_l = self.problem.theta(agg @ hd, yb) / (yb.shape[0] // mdom)
        th_z = th_l[:, None] * hd
        if doms:
            g_w2 = self._bwd_doms_wide(h, th_z, mdom, 1) if kernel \
                else _seg_contract(h, th_z, mdom)
        else:
            g_w2 = self._bwd(h, self._share(th_z), 1) if kernel \
                else h.transpose(1, 2) @ th_z
        du = (th_z @ w2.transpose(1, 2)) * (1.0 - h * h)
        g_b1 = du.view(du.shape[0], mdom, -1, du.shape[2]).sum(2) if doms \
            else du.sum(1)
        return du, g_b1, g_w2, agg.T @ th_l

    def _deep_round(self, b, dk: _DeepParts, hs, agg, yb, contract,
                    kernel: bool):
        """Apply one deep round from the activations ``hs`` and aggregate
        ``agg``: ``contract(∂u)`` forms xᵀ∂u (and, pipelined, the next
        round's forward) before ``dk.apply`` updates the loop's leaves in
        place.  Returns the four update directions (regularisers, and
        SVRG's μ, included)."""
        prob = self.problem
        sides, mdom = dk.sides, dk.mdom
        dr = b["head"].shape[1]
        tails = [self._deep_tail(h, agg[:, i * dr:(i + 1) * dr], yb,
                                 b["w2" + s], b["head" + s], mdom, kernel,
                                 dk.doms)
                 for i, (h, s) in enumerate(zip(hs, sides))]
        gx = contract(tails[0][0] if len(sides) == 1
                      else torch.cat([t[0] for t in tails], 2))
        lam = mdom * prob.lam
        if len(sides) == 1:
            g = []
            for a, k in zip((gx,) + tails[0][1:], _DEEP):
                reg = prob.reg_grad(b[k])
                # a per-dominator encoder slab carries λ∇g once, at its
                # dominator axis (−2); a summed update carries it mdom times
                g.append(a + (prob.lam * reg.unsqueeze(-2)
                              if dk.doms and k != "head" else lam * reg))
        else:
            hid = b["w1"].shape[2]
            data = (gx[..., :hid] - gx[..., hid:],) + tuple(
                a - c for a, c in zip(tails[0][1:], tails[1][1:]))
            g = [a + lam * (prob.reg_grad(b[k]) - prob.reg_grad(b[k + "s"]))
                 + mdom * b["m" + k] for a, k in zip(data, _DEEP)]
        dk.apply(b, g)
        return g

    def _deep_apply(self, b, g, gate=None):
        """The fresh update of the four leaves, in place: the masks freeze
        the padding and, under ``active_only``, the passive encoders;
        ``gate`` (q,), where given, freezes a party's encoder whole (the
        faulted epochs' backward liveness)."""
        lr = b["lr"]
        maskq, trainq = self.maskq, self.trainq
        if gate is not None:
            maskq, trainq = gate[:, None] * maskq, gate * trainq
        b["w1"].sub_(lr * maskq[..., None] * g[0])
        b["b1"].sub_(lr * trainq[:, None] * g[1])
        b["w2"].sub_(lr * trainq[:, None, None] * g[2])
        b["head"].sub_(lr * g[3])

    def _deep_delayed_apply(self, doms: bool, bl=None, de=None):
        """The bounded-delay update (``core.staleness``): the step's
        encoder gradients, regulariser included (per dominator under
        ``doms``), enter slot t mod (τ+1) of the loop's flat ring ``ring``
        (q, τ+1, m or 1, F); each party (each (party, dominator) pair)
        reads slot max(t − d, 0) mod (τ+1), and the stale gradients,
        summed over the dominators, take the fresh update's place.  The
        head applies its gradient fresh (delaying a replicated parameter
        would fork the replicas).  One ``index_copy_`` and one ``gather``
        a step, at device indices from the int64 counter ``step``.

        The faulted form gates the write and the encoder update by the
        backward liveness ``bl`` (q,) (a party that received no ϑ writes
        its old slot back and keeps its encoder) and reads slot
        max(t − de, 0) with ``de`` (q,) the step's delay + straggle."""
        def apply(b, g):
            ring, t = b["ring"], b["step"]
            slots = ring.shape[1]
            slot = (t % slots).view(1)
            enc = [a if doms else a.unsqueeze(-2) for a in g[:3]]
            new = torch.cat([a.movedim(-2, 1).flatten(2) for a in enc],
                            2).unsqueeze(1)
            if bl is not None:
                new = torch.where(bl.view(-1, 1, 1, 1) > 0, new,
                                  ring.index_select(1, slot))
            ring.index_copy_(1, slot, new)
            eff = (t - (b["delays"] if de is None else de)).clamp_min(0) \
                % slots                                     # (q[, m])
            stale = ring.gather(1, eff.view(self.qloc, 1, -1, 1).expand(
                -1, -1, *ring.shape[2:])).sum((1, 2))
            parts = stale.split([b[k][0].numel() for k in _DEEP[:3]], 1)
            self._deep_apply(b, [a.view_as(b[k]) for a, k in zip(parts, _DEEP)]
                             + [g[3]], bl)
            t.add_(1)

        return apply

    def _deep_xbwd(self, xb, du, dk: _DeepParts):
        """xᵀ∂u of a fresh step or a pipelined epilogue: summed over the
        rows, or the mdom dominators' slabs apart (one launch either
        way)."""
        if dk.doms:
            return self._bwd_doms_wide(xb, du, dk.mdom, 1)
        return self._bwd(xb, du, 1)

    def _deep_fresh_step(self, b, dk: _DeepParts):
        """A fresh deep step: 4 kernel launches (SVRG: 6)."""
        ib, xb, yb = self._batch(b)
        hs, agg = self._deep_acts(
            b, self._fwd(xb, self._deep_cols(b, dk.sides)), dk.sides, True)
        self._deep_round(b, dk, hs, agg, yb,
                         lambda du: self._deep_xbwd(xb, du, dk), True)

    def _deep_store(self, b, sides, hs, agg):
        """Carry the next round's activations and aggregate in the loop's
        buffers."""
        for h, s in zip(hs, sides):
            b["h" + s].copy_(h)
        b["agg"].copy_(agg)

    def _deep_pipe_step(self, b, dk: _DeepParts):
        """An interior pipelined deep step: exactly one kernel launch."""
        ib, xcat, yb = self._pair(b)
        sides = dk.sides

        def contract(du):
            cols = self._deep_cols(b, sides)
            if dk.doms:
                u, gx = self._pipe_doms_wide(xcat, ib.shape[0], cols, du,
                                             dk.mdom, 1)
            else:
                u, gx = self._pipe(xcat, ib.shape[0], cols, du, 1)
            # round t+1's read, at the params before round t's update
            self._deep_store(b, sides, *self._deep_acts(b, u, sides, False))
            return gx

        self._deep_round(b, dk, [b["h" + s] for s in sides], b["agg"], yb,
                         contract, False)

    def _deep_pipelined(self, loop: _StepLoop, dk: _DeepParts) -> None:
        """A pipelined deep epoch: the layer-1 forward prologue of schedule
        row 0, ``steps − 1`` interior steps and the backward epilogue of
        the last row (launches: steps + 1)."""
        b, sides = loop.bufs, dk.sides
        hs, agg = self._deep_acts(
            b, self._fwd(self._gather(b["idx"][0]), self._deep_cols(b, sides)),
            sides, False)
        for k, v in zip(["h" + s for s in sides] + ["agg"], hs + [agg]):
            if k not in b:
                b[k] = torch.empty_like(v)
        self._deep_store(b, sides, hs, agg)
        self._run(loop, lambda bufs: self._deep_pipe_step(bufs, dk),
                  b["idx"].shape[0] - 1)
        ib = b["idx"][-1]
        xb = self._gather(ib)
        self._deep_round(b, dk, [b["h" + s] for s in sides], b["agg"],
                         self.y.index_select(0, ib),
                         lambda du: self._deep_xbwd(xb, du, dk), False)

    def _deep_run(self, algo, multi, pipelined, dk: _DeepParts, pq, lr, idx,
                  mask_key, step_fn=None, **carries):
        """Run one deep epoch of kind ``dk`` from the party-stacked ``pq``
        and ``carries``; returns the loop's buffers.  The loop's name
        carries the form, ``algo`` and the deep widths.  ``step_fn``
        replaces the fresh step (the faulted epochs')."""
        kind = "deep_" + ("multi_" if multi else "") \
            + ("pipelined_" if pipelined else "") + algo
        loop = self._loop(kind + "_{}x{}".format(*pq[2].shape[1:]), idx, lr,
                          mask_key, **dict(zip(_DEEP, pq)), **carries)
        if pipelined:
            self._epoch(kind, loop, lambda: self._deep_pipelined(loop, dk))
        else:
            step_fn = step_fn or self._deep_fresh_step
            self._epoch(kind, loop,
                        lambda: self._run(loop, lambda b: step_fn(b, dk)))
        return loop.bufs

    def _deep(self, multi, pipelined, pq, lr, idx, mask_key, snap=None,
              muq=None):
        """One deep epoch from the party-stacked ``pq`` (SVRG: with the
        snapshot ``snap`` and its full gradient ``muq``); returns the new
        ``(w1q, b1q, w2q, headq)``."""
        svrg = snap is not None
        carries = {}
        if svrg:
            carries.update(zip((k + "s" for k in _DEEP), snap))
            carries.update(zip(("m" + k for k in _DEEP), muq))
        dk = _DeepParts(("", "s") if svrg else ("",),
                        self.layout.m if multi else 1, False,
                        self._deep_apply)
        b = self._deep_run("svrg" if svrg else "sgd", multi, pipelined, dk,
                           pq, lr, idx, mask_key, **carries)
        return tuple(b[k].clone() for k in _DEEP)

    def _deep_delayed(self, multi, pipelined, pq, bufq, t0, delays, lr, idx,
                      tau, mask_key):
        self._check_rows("bufq", bufq[0])
        self._check_rows("delays", delays)
        if bufq[0].shape[1] != tau + 1:
            raise ValueError(f"bufq holds {bufq[0].shape[1]} ring slots; "
                             f"tau={tau} needs {tau + 1}")
        dk = _DeepParts(("",), self.layout.m if multi else 1, multi,
                        self._deep_delayed_apply(multi))
        b = self._deep_run(f"delayed{tau}", multi, pipelined, dk, pq, lr, idx,
                           mask_key, delays=delays, step=t0,
                           ring=_ring_flat([self._carry(r) for r in bufq],
                                           multi))
        leaves = tuple(b[k].clone() for k in _DEEP)
        return leaves, _ring_split(b["ring"], leaves, multi), \
            b["step"].clone()

    def deep_sgd_epoch(self, pq, lr, idx, mask_key=(0,)):
        """One deep VFB²-SGD epoch over the schedule ``idx`` (steps, B) from
        the party-stacked ``pq = (w1q, b1q, w2q, headq)`` of
        :meth:`pack_deep`; returns the new ``pq``."""
        return self._deep(False, False, pq, lr, idx, mask_key)

    def deep_multi_sgd_epoch(self, pq, lr, idx, mask_key=(0,)):
        """Deep VFB²-SGD with all m = layout.m dominators per step over the
        (steps, m·B) schedule: one encoder pass over the concatenated
        minibatches, one aggregation of all m partial sets, the summed
        Jacobian-transpose updates."""
        return self._deep(True, False, pq, lr, idx, mask_key)

    def deep_pipelined_sgd_epoch(self, pq, lr, idx, mask_key=(0,)):
        """Pipelined deep VFB²-SGD (τ = 1): one split-batch launch per
        interior step."""
        return self._deep(False, True, pq, lr, idx, mask_key)

    def deep_multi_pipelined_sgd_epoch(self, pq, lr, idx, mask_key=(0,)):
        """Pipelined multi-dominator deep VFB²-SGD over the (steps, m·B)
        schedule."""
        return self._deep(True, True, pq, lr, idx, mask_key)

    def deep_svrg_epoch(self, pq, pq_snap, muq, lr, idx, mask_key=(0,)):
        """Deep VFB²-SVRG inner loop: v = g(w) − g(w̃) + μ per leaf, with
        ``muq`` from :meth:`deep_full_gradient` at the snapshot."""
        return self._deep(False, False, pq, lr, idx, mask_key, pq_snap, muq)

    def deep_multi_svrg_epoch(self, pq, pq_snap, muq, lr, idx,
                              mask_key=(0,)):
        """Multi-dominator deep VFB²-SVRG: the m summed variance-reduced
        updates, v = Σ_j[g₁ⱼ − g₀ⱼ] + m·(λ∇g(w) − λ∇g(w̃)) + m·μ."""
        return self._deep(True, False, pq, lr, idx, mask_key, pq_snap, muq)

    def deep_pipelined_svrg_epoch(self, pq, pq_snap, muq, lr, idx,
                                  mask_key=(0,)):
        """Pipelined deep VFB²-SVRG: both sides ride one M = 2·hidden
        split-batch launch per interior step; the snapshot is constant, so
        its stale read is delay-free."""
        return self._deep(False, True, pq, lr, idx, mask_key, pq_snap, muq)

    def deep_multi_pipelined_svrg_epoch(self, pq, pq_snap, muq, lr, idx,
                                        mask_key=(0,)):
        """Pipelined multi-dominator deep VFB²-SVRG."""
        return self._deep(True, True, pq, lr, idx, mask_key, pq_snap, muq)

    # -- bounded-delay deep epochs (core.staleness semantics) ----------------
    #
    # Party ℓ applies at global step t its encoder gradients of step
    # t − d_ℓ (clamped at the first step) from a ring of the last τ+1;
    # the dominator-held head applies its gradient fresh.  ``bufq`` is
    # (w1, b1, w2) rings (q, τ+1, ...) of :meth:`deep_delay_buffers` with
    # ``delays`` (q,), or, for the multi-dominator forms, per (party,
    # dominator) rings (q, τ+1, dp, m, hid), (q, τ+1, m, hid),
    # (q, τ+1, hid, m, dr) of :meth:`deep_multi_delay_buffers` with (q, m)
    # delays; the reference's layouts, held inside the loop as one flat
    # ring.  Each epoch returns ``(pq, bufq, t0 + steps)``, the counter a
    # 0-d int64 device tensor, as the linear delayed epochs do.  A fresh
    # step makes 4 launches (multi: 2 forwards and 2 per-dominator
    # backwards, ``_bwd_doms_wide``), a pipelined interior step exactly 1
    # (multi: ``_pipe_doms_wide``, Mw = hidden and Mθ = m·hidden).

    def deep_delay_buffers(self, pq, tau: int):
        """Zeroed per-party encoder gradient rings for
        :meth:`deep_delayed_sgd_epoch`: (q, τ+1, ...) per leaf of
        (w1q, b1q, w2q) — the rows of ``pq``, so on a device mesh the
        rank's (qloc, τ+1, ...)."""
        return tuple(torch.zeros((a.shape[0], tau + 1) + tuple(a.shape[1:]),
                                 device=self.device) for a in pq[:3])

    def deep_multi_delay_buffers(self, pq, tau: int):
        """Zeroed per-(party, dominator) encoder gradient rings for
        :meth:`deep_multi_delayed_sgd_epoch`: each leaf's dominator axis
        sits before its last, (q, τ+1, dp, m, hid), (q, τ+1, m, hid),
        (q, τ+1, hid, m, dr) — the rows of ``pq``, as
        :meth:`deep_delay_buffers`'s."""
        m = self.layout.m
        return tuple(torch.zeros((a.shape[0], tau + 1) + tuple(a.shape[1:-1])
                                 + (m, a.shape[-1]), device=self.device)
                     for a in pq[:3])

    def deep_delayed_sgd_epoch(self, pq, bufq, t0, delays, lr, idx, tau,
                               mask_key=(0,)):
        """Bounded-delay deep VFB²-SGD over the (steps, B) schedule
        ``idx``; ``staleness.train_deep_delayed`` is the oracle."""
        return self._deep_delayed(False, False, pq, bufq, t0, delays, lr,
                                  idx, tau, mask_key)

    def deep_multi_delayed_sgd_epoch(self, pq, bufq, t0, delays, lr, idx,
                                     tau, mask_key=(0,)):
        """Bounded-delay multi-dominator deep VFB²-SGD over the (steps, m·B)
        schedule: dominator j's Jacobian-transpose slabs age in ring
        column j under party ℓ's delay d_{ℓ,j}; the head applies the
        fresh summed gradient.  ``staleness.train_deep_multi_delayed`` is
        the oracle."""
        return self._deep_delayed(True, False, pq, bufq, t0, delays, lr,
                                  idx, tau, mask_key)

    def deep_pipelined_delayed_sgd_epoch(self, pq, bufq, t0, delays, lr,
                                         idx, tau, mask_key=(0,)):
        """Pipelined bounded-delay deep VFB²-SGD: each round's stale-read
        (τ = 1) encoder gradients enter the ring (total delay τ + 1)."""
        return self._deep_delayed(False, True, pq, bufq, t0, delays, lr,
                                  idx, tau, mask_key)

    def deep_multi_pipelined_delayed_sgd_epoch(self, pq, bufq, t0, delays,
                                               lr, idx, tau, mask_key=(0,)):
        """Pipelined bounded-delay multi-dominator deep VFB²-SGD: the m
        stale-read slabs are the Mθ = m·hidden block-diagonal columns of
        the one split launch per interior step."""
        return self._deep_delayed(True, True, pq, bufq, t0, delays, lr,
                                  idx, tau, mask_key)

    # -- deep faulted and guarded epochs (core.faults semantics) --------------
    #
    # The bounded-delay deep SGD and SVRG epochs with the linear faulted
    # epochs' channels: the loop buffer ``chan`` (4, q, steps) read at the
    # device counter, the survivor aggregation (``_agg_members``) of the
    # (q, B, d_rep) vector partials (SVRG: both sides', (q, B, 2·d_rep))
    # under the forward liveness, the flat encoder ring of
    # ``_deep_delayed_apply`` written only where the party received ϑ and
    # read at max(t − (d + e), 0) mod (τ+1), and a crashed or cut-off
    # party's encoder (w1, b1, w2) frozen whole.  The replicated head is
    # dominator-held protocol state and applies its gradient fresh at
    # every step.  Guarded: the corrupt code rewrites each party's partial
    # before the survivor sum, ``guard=True`` quarantines a non-finite one,
    # and the step writes (finite, alive, max |z|, max |·| over the
    # party's w1, b1 and w2 directions) into ``health`` at its index.  A
    # step makes a fresh deep step's launches (4; SVRG 6); SVRG's μ̃ comes
    # from :meth:`deep_full_gradient`, a full-membership round at the
    # epoch boundary.  ``bufq`` and the returned rings are the per-party
    # (w1, b1, w2) rings of :meth:`deep_delay_buffers`.

    def _deep_faulted_step(self, b, dk: _DeepParts, guard):
        """One deep faulted (``guard`` None) or guarded step at the device
        counter ``t``."""
        ch, ib = self._fault_column(b)
        xb = self._gather(ib)
        live, stats = ch[0], []

        def agg(z):
            nonlocal live
            if guard is not None:
                z, live, healthy, pnorm = self._guard_fwd(z, ch[2], live,
                                                          guard)
                stats.extend((healthy, pnorm))
            return self._agg_members(z, self._gen, live, self._step_key(b))

        hs, aggv = self._deep_acts(
            b, self._fwd(xb, self._deep_cols(b, dk.sides)), dk.sides, True,
            agg)
        step = dk._replace(apply=self._deep_delayed_apply(
            False, ch[1], ch[3].long()))
        g = self._deep_round(b, step, hs, aggv, self.y.index_select(0, ib),
                             lambda du: self._deep_xbwd(xb, du, dk), True)
        if guard is not None:
            gnorm = torch.stack([a.abs().flatten(1).amax(1)
                                 for a in g[:3]]).amax(0)
            b["health"].index_copy_(2, b["t"], torch.stack(
                [stats[0], live, stats[1], gnorm]).unsqueeze(2))
        b["t"].add_(1)

    def _deep_faulted(self, algo, guard, pq, bufq, t0, delays, fwdq, bwdq,
                      extraq, corruptq, lr, idx, tau, mask_key, snap=None,
                      muq=None):
        """Run one deep faulted (``guard`` None) or guarded epoch; returns
        ``(pq, bufq, t0 + steps)`` and, guarded, the ``HealthStats``."""
        self._check_rows("bufq", bufq[0])
        if bufq[0].shape[1] != tau + 1:
            raise ValueError(f"bufq holds {bufq[0].shape[1]} ring slots; "
                             f"tau={tau} needs {tau + 1}")
        carries = {"step": t0,
                   "ring": _ring_flat([self._carry(r) for r in bufq], False)}
        self._fault_channels(delays, fwdq, bwdq, extraq, corruptq, len(idx),
                             guard, carries)
        if snap is not None:
            carries.update(zip((k + "s" for k in _DEEP), snap))
            carries.update(zip(("m" + k for k in _DEEP), muq))
        dk = _DeepParts(("", "s") if snap is not None else ("",), 1, False,
                        None)
        kind = f"faulted_{algo}{tau}" if guard is None \
            else f"guarded_{algo}{tau}_{int(bool(guard))}"
        b = self._deep_run(kind, False, False, dk, pq, lr, idx, mask_key,
                           step_fn=lambda bb, d: self._deep_faulted_step(
                               bb, d, guard), **carries)
        leaves = tuple(b[k].clone() for k in _DEEP)
        out = (leaves, _ring_split(b["ring"], leaves, False),
               b["step"].clone())
        if guard is None:
            return out
        return out + (HealthStats(*b["health"].clone()),)

    def deep_faulted_sgd_epoch(self, pq, bufq, t0, delays, fwdq, bwdq,
                               extraq, lr, idx, tau, mask_key=(0,)):
        """Fault-trace deep VFB²-SGD over the (steps, B) schedule ``idx``
        from the party-stacked ``pq`` and the per-party encoder rings
        ``bufq``: ``fwdq``/``bwdq`` (q, steps) 0/1 forward and backward
        liveness, ``extraq`` (q, steps) straggle's delay added to
        ``delays`` (q,).  Returns ``(pq, bufq, t0 + steps)``;
        ``faults.run_deep_faulted_reference`` drives the oracle."""
        return self._deep_faulted("sgd", None, pq, bufq, t0, delays, fwdq,
                                  bwdq, extraq, 0, lr, idx, tau, mask_key)

    def deep_faulted_svrg_epoch(self, pq, pq_snap, muq, bufq, t0, delays,
                                fwdq, bwdq, extraq, lr, idx, tau,
                                mask_key=(0,)):
        """Fault-trace deep VFB²-SVRG inner loop: both encoder passes
        (iterate and snapshot) give survivor-aggregated partials, the
        per-leaf v = g(w) − g(w̃) + μ̃ ages in the gated ring, the head
        applies its v fresh.  ``muq`` from :meth:`deep_full_gradient` at
        the snapshot.  Returns ``(pq, bufq, t0 + steps)``."""
        return self._deep_faulted("svrg", None, pq, bufq, t0, delays, fwdq,
                                  bwdq, extraq, 0, lr, idx, tau, mask_key,
                                  pq_snap, muq)

    def deep_guarded_sgd_epoch(self, pq, bufq, t0, delays, fwdq, bwdq,
                               extraq, corruptq, lr, idx, tau,
                               mask_key=(0,), guard: bool = True):
        """Guarded deep VFB²-SGD: the corrupt channel ``corruptq``
        (q, steps) rewrites each party's (B, d_rep) partial before the
        survivor sum; ``guard=True`` quarantines a non-finite one.
        Returns ``(pq, bufq, t0 + steps, HealthStats)``."""
        return self._deep_faulted("sgd", guard, pq, bufq, t0, delays, fwdq,
                                  bwdq, extraq, corruptq, lr, idx, tau,
                                  mask_key)

    def deep_guarded_svrg_epoch(self, pq, pq_snap, muq, bufq, t0, delays,
                                fwdq, bwdq, extraq, corruptq, lr, idx, tau,
                                mask_key=(0,), guard: bool = True):
        """Guarded deep VFB²-SVRG inner loop: a party's message is both
        partials (iterate and snapshot, (B, 2·d_rep)); one code corrupts
        both and the verdict covers both."""
        return self._deep_faulted("svrg", guard, pq, bufq, t0, delays, fwdq,
                                  bwdq, extraq, corruptq, lr, idx, tau,
                                  mask_key, pq_snap, muq)

    def deep_full_gradient(self, pq, mask_key=(0,)):
        """The full-dataset deep BUM gradient at ``pq`` (SVRG's μ), every
        leaf party-stacked as ``pq`` is: one masked aggregation and the
        two layers' forward and backward over all n samples."""
        prob = self.problem
        b = dict(zip(_DEEP, (self._carry(a) for a in pq)))
        gen = self._reseed(*mask_key, _TAG_FULL)
        h = torch.tanh(self._fwd(self.xs, b["w1"]) + b["b1"][:, None])
        agg = self._agg(self._fwd(h, b["w2"]), gen)
        du, *rest = self._deep_tail(h, agg, self.y, b["w2"], b["head"], 1,
                                    True)
        return tuple(a + prob.lam * prob.reg_grad(b[k]) for a, k in
                     zip([self._bwd(self.xs, du, 1)] + rest, _DEEP))

    def deep_objective(self, pq) -> float:
        """Full deep objective (one device sync; per-epoch telemetry).  The
        padded w1 rows are zero and every shipped regulariser maps 0 → 0,
        so summing ``reg`` over the padded stack is exact; the replicated
        head counts once.  On a device mesh the layer-2 partials and the
        encoders' regularisers add up over the model group, and the head's
        regulariser is added once after the sum."""
        prob = self.problem
        w1q, b1q, w2q, headq = pq
        h = torch.tanh(self._fwd(self.xs, w1q) + b1q[:, None])
        z = self._fwd(h, w2q).sum(0)
        regv = sum(torch.sum(prob.reg(a)) for a in (w1q, b1q, w2q))
        if self._dist is not None:
            z, regv = psum_dist(z, self._mgroup), psum_dist(regv, self._mgroup)
        regv = regv + torch.sum(prob.reg(headq[0]))
        return float(torch.mean(prob.loss(z @ headq[0], self.y))
                     + prob.lam * regv)

    def objective(self, wq) -> float:
        """Full objective (one device sync; for per-epoch telemetry).

        The padded coordinates are zero and every shipped regularizer maps
        0 → 0, so summing ``reg`` over the padded stack is exact.  On a
        device mesh the partial sums and the regulariser add up over the
        model group."""
        prob = self.problem
        agg = self._fwd(self.xs, wq).sum(0)
        reg = torch.sum(prob.reg(wq))
        if self._dist is not None:
            agg, reg = psum_dist(agg, self._mgroup), psum_dist(reg,
                                                               self._mgroup)
        return float(torch.mean(prob.loss(agg, self.y)) + prob.lam * reg)

    # -- boundary helpers ----------------------------------------------------

    def pack_w(self, w) -> torch.Tensor:
        """(d,) -> this engine's (qloc, dp) party-stacked rows."""
        return pack_vec(w, self.layout, self.device, self.parties)

    def unpack_w(self, wq) -> np.ndarray:
        """(qloc, dp) rows -> the whole (d,) iterate (on a device mesh,
        gathered over the model group)."""
        return unpack_vec(self.gather(wq), self.layout)

    def pack_deep(self, params: DeepVFLParams):
        """``DeepVFLParams`` -> this engine's party-stacked ``(w1q, b1q,
        w2q, headq)`` rows (qloc each)."""
        return pack_deep_params(params, self.layout, self.device,
                                self.parties)

    def unpack_deep(self, pq) -> DeepVFLParams:
        """This engine's party-stacked rows -> the whole ``DeepVFLParams``
        (on a device mesh each encoder leaf gathered over the model group;
        the head is read from the rank's first row, every copy being
        equal)."""
        w1q, b1q, w2q, headq = pq
        return unpack_deep_params((self.gather(w1q), self.gather(b1q),
                                   self.gather(w2q), headq), self.layout)
