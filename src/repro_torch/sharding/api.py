"""The party mesh of the fused engine and the LM stack's runtime settings:
the port of ``repro.sharding.api``'s ``PartyMesh`` and of its ``Runtime``
(the fields the SSM, dense and MoE paths read).

``PartyMesh`` factors the q logical parties as slots × parties per slot,
plus a sample-parallel data axis; the port runs it on one device
(``mesh=None``), where the factors shape the masked aggregation and the
data-axis slicing, not the placement.

There is no device mesh: the q parties are a leading tensor dimension on one
device, so ``model_size`` is q itself.  The decode KV cache's sequence
axis is sharded over the q parties, as the reference's
``cache_seq_axes=("model",)`` shards it: on one device the cache is
viewed as q shards of S/q positions, so no field is needed for it.
There is no ``use_runtime`` global either: every model function takes
its ``Runtime`` explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SECURE_MODES = ("two_tree", "ring_masks")


@dataclasses.dataclass(frozen=True)
class PartyMesh:
    """The logical party axis factored as ``q = slots × parties_per_slot``,
    with an optional sample-parallel data axis of ``data_shards``.

    On one device the party axis is the leading tensor dimension; a
    packed mesh (more than one party a slot) makes the masked aggregation
    two-level (``secure_agg.secure_psum_hier``: within each slot, then
    across the slots' sums), and ``data_shards > 1`` splits each fresh
    SGD and SVRG minibatch into that many disjoint slices, each
    aggregated with its own mask draw.  The axis names are the
    reference's and are checked as there; nothing on one device reads
    them.  ``pods`` is the width of the reference's inter-pod axis,
    "pod" (``launch.mesh``'s multi-pod production mesh), None where the
    mesh has none; nothing on one device reads it either.

    ``mesh`` is the reference's device mesh.  The port has none, so
    ``mesh=None`` is the only form it runs: any other value raises
    ``NotImplementedError`` rather than being emulated silently (the
    reference's rule for a supplied mesh)."""

    q: int                          # logical party count
    slots: int                      # physical party-axis width
    mesh: Optional[object] = None   # device mesh; only None runs here
    axis: str = "model"             # outer (slot) axis name
    party_axis: str = "party"       # inner (packed parties) axis name
    data_shards: int = 1            # sample-parallel width
    data_axis: str = "data"         # batch axis name
    pods: Optional[int] = None      # "pod" axis width; None: no pod axis

    def __post_init__(self):
        if self.q < 1 or self.slots < 1 or self.data_shards < 1 or (
                self.pods is not None and self.pods < 1):
            raise ValueError(
                f"PartyMesh sizes must be >= 1; got q={self.q}, "
                f"slots={self.slots}, data_shards={self.data_shards}, "
                f"pods={self.pods}")
        if self.q % self.slots != 0:
            raise ValueError(
                f"q={self.q} must divide evenly into slots={self.slots} "
                f"islands (got remainder {self.q % self.slots})")
        names = (self.axis, self.party_axis, self.data_axis, "pod")
        if len(set(names)) != len(names):
            raise ValueError(
                f"axis names must be distinct (and not 'pod'); got "
                f"axis={self.axis!r}, party_axis={self.party_axis!r}, "
                f"data_axis={self.data_axis!r}")
        if self.mesh is not None:
            raise NotImplementedError(
                "PartyMesh(mesh=...): a device mesh (the multi-device "
                "torch.distributed port of the party mesh) is not ported; "
                "the port runs the party mesh on one device, mesh=None")

    @property
    def parties_per_slot(self) -> int:
        return self.q // self.slots

    @property
    def packed(self) -> bool:
        """More than one logical party per slot (the two-level
        aggregation)."""
        return self.parties_per_slot > 1

    @property
    def axis_names(self):
        """The reference device mesh's axis names: (pod,) data, model."""
        pod = () if self.pods is None else ("pod",)
        return pod + (self.data_axis, self.axis)

    @property
    def shape(self):
        """Axis name -> size, as the reference's ``Mesh.shape``; the model
        axis is the slots."""
        sizes = (() if self.pods is None else (self.pods,)) \
            + (self.data_shards, self.slots)
        return dict(zip(self.axis_names, sizes))
SCAN_IMPLS = ("kernel", "reference")
ATTN_IMPLS = ("kernel", "reference")
MOE_DISPATCHES = ("replicated", "alltoall")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """``model_size``: the party count q (each party owns a V/q block of
    the vocabulary).  ``secure_embed``: embed through the parties'
    masked aggregation (else a plain table lookup).  ``mask_scale``,
    ``schedule_faithful`` and ``secure_mode`` configure that aggregation
    (``"two_tree"``: Algorithm 1; ``"ring_masks"``: pairwise-cancelling
    ring masks).  ``scan_impl``: ``"kernel"`` runs ``ops.selective_scan``
    (the CUDA kernel on the card; the counterpart of the reference's
    ``"pallas"``), ``"reference"`` the sequential oracle.  ``attn_impl``:
    ``"kernel"`` runs ``ops.flash_attention`` in the prefill and
    ``ops.decode_attention`` over all q cache shards in a decode step
    (the CUDA kernels on the card), ``"reference"`` the plain
    ``chunked_attention`` and ``local_decode_attention`` per shard.
    ``attn_chunk``: the query chunk of ``chunked_attention``.
    ``loss_chunk``: the sequence chunk of ``vfl.heads.vocab_parallel_loss``
    (each chunk's logits are recomputed in the backward, so the (B, S, V)
    f32 logits never exist whole).  The kernel routes are forward-only
    (``kernels.ops``): ``train_loss`` under autograd needs
    ``scan_impl="reference"`` and ``attn_impl="reference"``, and raises on
    a kernel route; under ``torch.no_grad()`` both routes run.
    ``moe_dispatch``: how ``models.moe.apply_moe_sharded`` spreads an MoE
    layer over the parties, ``"replicated"`` (each party routes every
    token and computes its E/q experts; the partial outputs are summed)
    or ``"alltoall"`` (each party routes its 1/q token slice and its
    buckets travel to the experts' parties and back).  The reference's
    ``moe_capacity_data_sharded`` is read nowhere in the reference, so it
    is not ported.
    ``remat`` (on by default, as in the reference): under autograd,
    ``train_loss`` keeps only each block's input and recomputes the
    block in the backward (``torch.utils.checkpoint``), a uniform stack's
    every layer, a period stack's every whole period and the encoder's
    every block; prefill and decode, which fill a cache or run without
    grad, are never checkpointed.  ``unroll_layers``: None (every layer)
    or n >= 1, run only the first min(n, ·) layers of a full-depth tree:
    a uniform stack's layers, a period stack's whole periods, an
    encoder's layers; ``prefill``'s cache and ``decode_step``'s returned
    cache hold only those layers.  ``seq_parallel_norms``: the
    reference's sharding annotation of the residual stream over the
    party axis; on one device there is nothing to shard, so it changes
    no value."""

    model_size: int = 1
    secure_embed: bool = True
    mask_scale: float = 1.0
    schedule_faithful: bool = False
    secure_mode: str = "two_tree"
    scan_impl: str = "kernel"
    attn_impl: str = "kernel"
    attn_chunk: int = 1024
    loss_chunk: int = 512
    moe_dispatch: str = "replicated"
    remat: bool = True
    unroll_layers: Optional[int] = None
    seq_parallel_norms: bool = False

    def __post_init__(self):
        if self.model_size < 1:
            raise ValueError(f"model_size must be >= 1; got "
                             f"{self.model_size}")
        if self.secure_mode not in SECURE_MODES:
            raise ValueError(f"secure_mode must be one of {SECURE_MODES}; "
                             f"got {self.secure_mode!r}")
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl must be one of {SCAN_IMPLS}; got "
                             f"{self.scan_impl!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}; got "
                             f"{self.attn_impl!r}")
        if self.attn_chunk < 1:
            raise ValueError(f"attn_chunk must be >= 1; got "
                             f"{self.attn_chunk}")
        if self.loss_chunk < 1:
            raise ValueError(f"loss_chunk must be >= 1; got "
                             f"{self.loss_chunk}")
        if self.moe_dispatch not in MOE_DISPATCHES:
            raise ValueError(f"moe_dispatch must be one of "
                             f"{MOE_DISPATCHES}; got {self.moe_dispatch!r}")
        if self.unroll_layers is not None and (
                not isinstance(self.unroll_layers, int)
                or self.unroll_layers < 1):
            raise ValueError(f"unroll_layers must be None or an int >= 1; "
                             f"got {self.unroll_layers!r}")
