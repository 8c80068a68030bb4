"""The production meshes on one device (the port of ``repro.launch.mesh``).

The reference lays its runs out on TPU meshes: single pod (data=16,
model=16), 256 chips; multi-pod (pod=2, data=16, model=16), 512 chips.
"model" is the party axis (q = 16 vertical-federated parties), "data" the
intra-party collaborative level, "pod" the inter-active-party-group level
of BAPA.

The port runs on one card, so these are ``PartyMesh`` descriptions with
``mesh=None``: the reference's axis names and sizes (``axis_names``,
``shape``) and nothing placed on a device.  A device mesh
(``PartyMesh(mesh=...)``) is out of this round.  ``launch.dryrun`` reads
the data axis (and the pods) to take one data shard of a shape's global
batch.  Nothing here touches a device.
"""
from __future__ import annotations

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
