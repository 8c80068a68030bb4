"""The party mesh of the fused engine and the LM stack's runtime settings:
the port of ``repro.sharding.api``'s ``PartyMesh`` and of its ``Runtime``
(the fields the SSM, dense and MoE paths read).

``PartyMesh`` factors the q logical parties as slots × parties per slot,
plus a sample-parallel data axis.  Without a device mesh (``mesh=None``)
the engine runs it on one device, where the factors shape the masked
aggregation and the data-axis slicing, not the placement.  With a
``torch.distributed`` ``DeviceMesh`` (``launch.mesh.make_device_mesh``)
each rank holds one slot of parties and one data shard, and the
aggregations are collectives over the mesh's process groups.

The LM stack has no device mesh: the q parties are a leading tensor
dimension on one device, so ``model_size`` is q itself.  The decode KV
cache's sequence axis is sharded over the q parties, as the reference's
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

    Without ``mesh`` the party axis is the leading tensor dimension on
    one device; a packed mesh (more than one party a slot) makes the
    masked aggregation two-level (``secure_agg.secure_psum_hier``: within
    each slot, then across the slots' sums), and ``data_shards > 1``
    splits each fresh SGD and SVRG minibatch into that many disjoint
    slices, each aggregated with a mask draw of its own.  ``pods`` is the
    width of the reference's inter-pod axis, "pod" (``launch.mesh``'s
    multi-pod production mesh), None where the mesh has none.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` (the
    counterpart of the reference's ``jax.sharding.Mesh``, as its
    ``shard_map`` binds it): its dimension ``axis`` ("model") has size
    ``slots`` and ``data_axis`` ("data") size ``data_shards``, plus
    "pod" of size ``pods`` where ``pods`` is set.  A rank then holds
    slot :attr:`slot`, its logical parties :attr:`parties`, and data
    shard :attr:`data_index`; :attr:`model_group` and :attr:`data_group`
    are the process groups its collectives run over.  The pod axis
    replicates: each pod runs the same program."""

    q: int                          # logical party count
    slots: int                      # physical party-axis width
    mesh: Optional[object] = None   # torch.distributed DeviceMesh, or None
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
            self._check_device_mesh()

    def _check_device_mesh(self):
        """The reference's shape checks (a ``model`` dimension of size
        ``slots``, a ``data`` one of size ``data_shards``), plus "pod" of
        size ``pods`` where it is set."""
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(
                f"PartyMesh(mesh=...) takes a torch.distributed "
                f"DeviceMesh or None; got {type(self.mesh).__name__}")
        names = self.mesh.mesh_dim_names or ()
        shape = dict(zip(names, self.mesh.mesh.shape))
        want = {self.axis: self.slots, self.data_axis: self.data_shards}
        if self.pods is not None:
            want["pod"] = self.pods
        for name, size in want.items():
            if shape.get(name) != size:
                raise ValueError(
                    f"mesh must carry a {name!r} dimension of size {size}; "
                    f"got dimensions {shape}")
        extra = set(names) - set(want)
        if extra:
            raise ValueError(f"mesh has dimensions {sorted(extra)} beside "
                             f"{sorted(want)}")

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

    # -- this rank's place on a device mesh ----------------------------------

    def _device_mesh(self):
        if self.mesh is None:
            raise ValueError("this PartyMesh has no device mesh")
        return self.mesh

    @property
    def slot(self) -> int:
        """This rank's slot: its coordinate on the model dimension."""
        return self._device_mesh().get_local_rank(self.axis)

    @property
    def parties(self) -> range:
        """This rank's logical parties, [slot·pps, (slot+1)·pps)."""
        pps = self.parties_per_slot
        return range(self.slot * pps, (self.slot + 1) * pps)

    @property
    def data_index(self) -> int:
        """This rank's data shard: its coordinate on the data dimension."""
        return self._device_mesh().get_local_rank(self.data_axis)

    @property
    def model_group(self):
        """The process group of this rank's data shard across the slots:
        the party-axis collectives run over it."""
        return self._device_mesh().get_group(self.axis)

    @property
    def data_group(self):
        """The process group of this rank's slot across the data shards:
        the data axis's gradient sum runs over it."""
        return self._device_mesh().get_group(self.data_axis)

    @property
    def backend(self) -> str:
        """The collectives' backend, ``"nccl"`` or ``"gloo"``."""
        import torch.distributed as dist
        return str(dist.get_backend(self.model_group))


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
