"""The production meshes (the port of ``repro.launch.mesh``).

The reference lays its runs out on TPU meshes: single pod (data=16,
model=16), 256 chips; multi-pod (pod=2, data=16, model=16), 512 chips.
"model" is the party axis (q = 16 vertical-federated parties), "data" the
intra-party collaborative level, "pod" the inter-active-party-group level
of BAPA.

``make_production_mesh`` and ``make_mesh_for`` are ``PartyMesh``
descriptions with ``mesh=None``: the reference's axis names and sizes
(``axis_names``, ``shape``) and nothing placed on a device.
``launch.dryrun`` reads their data axis (and the pods) to take one data
shard of a shape's global batch.  Nothing in them touches a device.

``make_device_mesh`` is the counterpart of the reference's
``make_mesh_for`` that places the mesh: a ``torch.distributed``
``DeviceMesh`` over the process group the caller initialised, one rank a
(pod, data shard, slot), returned inside the ``PartyMesh`` that
``FusedEngine(..., mesh=...)`` runs on.  Its backend and device are
explicit (``"nccl"`` on ``"cuda"`` by default); it never falls back from
NCCL to gloo or from the card to the CPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import resolve_device
from repro_torch.sharding.api import PartyMesh

PRODUCTION_PARTIES = 16        # the model axis: q = slots = 16
PRODUCTION_DATA = 16           # the data axis
PRODUCTION_PODS = 2            # the multi-pod mesh's pod axis


def make_production_mesh(*, multi_pod: bool = False) -> PartyMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, as a one-device ``PartyMesh``."""
    return PartyMesh(q=PRODUCTION_PARTIES, slots=PRODUCTION_PARTIES,
                     data_shards=PRODUCTION_DATA,
                     pods=PRODUCTION_PODS if multi_pod else None)


def make_mesh_for(devices: int, model_parallel: int,
                  pods: int = 1) -> PartyMesh:
    """Smaller meshes for tests and examples, the reference's arithmetic:
    data = devices // (model_parallel · pods), the axes (pod, data,
    model), the pod axis kept at size 1."""
    data = devices // (model_parallel * pods)
    return PartyMesh(q=model_parallel, slots=model_parallel,
                     data_shards=data, pods=pods)


def batch_axes_for(mesh: PartyMesh):
    """The axes a batch is split over: (pod, data) where the mesh has more
    than one pod, else (data,)."""
    if "pod" in mesh.axis_names and mesh.shape.get("pod", 1) > 1:
        return ("pod", "data")
    return ("data",)


def make_device_mesh(model_parallel: int, *, q: Optional[int] = None,
                     pods: Optional[int] = None, backend: str = "nccl",
                     device="cuda") -> PartyMesh:
    """A ``PartyMesh`` of ``q`` parties (default ``model_parallel``, one a
    slot) on a ``DeviceMesh`` over every rank of the initialised default
    process group: dimensions (pod,) data, model, the model dimension
    ``model_parallel`` wide and data = world // (model_parallel · pods).
    The process group's backend must be ``backend`` and the device's type
    the mesh's; a CUDA device without a card raises, as every entry point
    of the port does.  Tests pass ``backend="gloo", device="cpu"``.  Each
    rank must call it (it makes the mesh's process groups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    got = str(dist.get_backend())
    if got != backend:
        raise ValueError(f"the process group's backend is {got!r}, not the "
                         f"requested {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device; got {dev}")
    world, pod = dist.get_world_size(), pods or 1
    if model_parallel < 1 or world % (model_parallel * pod):
        raise ValueError(f"world size {world} does not split into "
                         f"pods={pod} x data x model={model_parallel}")
    data = world // (model_parallel * pod)
    shape = ((pods,) if pods is not None else ()) + (data, model_parallel)
    names = (("pod",) if pods is not None else ()) + ("data", "model")
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    return PartyMesh(q=model_parallel if q is None else q,
                     slots=model_parallel, data_shards=data, pods=pods,
                     mesh=mesh)
