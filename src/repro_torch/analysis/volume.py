"""Per-step party-boundary volume, counted from the trace.

The counterpart of ``repro.analysis.volume``, which compiles selected
epochs on a real ("model",) mesh and reads the collectives of the
post-SPMD HLO.  On one device the port runs its parties as dim 0 of one
tensor, so the volume is counted from the traced step instead
(:func:`step_volume`).  Each party-axis boundary (``taint.boundaries``)
of one step adds, per party, its operand's elements that party holds
times the dtype's size: an aggregation of a (q, B) f32 partial moves
4·B bytes a party.  Kinds follow the HLO names: a reduction is an
``all-reduce``, a permutation a ``collective-permute``, a prefix scan a
``scan``.  A permutation of mask draws alone (the ring's ``roll``)
stands in for a shared seed and moves nothing (``taint``'s rule), so
``ring`` moves what ``off`` moves; the two-tree form moves the masked
sum and the mask sum.

On a device mesh (``PartyMesh(mesh=DeviceMesh)``) a rank's program holds
the collectives themselves, as the reference's HLO does:
:func:`rank_volume` counts the c10d nodes of one step over the model
group (``taint``'s c10d rule), each operand's bytes as the rank sends
them — an ``all_reduce`` operand (``all-reduce``), a tree round's sent
operand (``collective-permute``), a broadcast's operand
(``collective-broadcast``).  A rank's local sums over its own parties
(a packed slot's level 1) are not messages, and the data group's sums
are left out, as the reference's ``jaxpr_collective_volume(axes=)``
leaves out the data axis.  On the flat mesh of q ranks every rank's
account equals the one-device :func:`step_volume` and the reference's
figures (``analysis/INVARIANTS.json["collectives"]``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from repro_torch.analysis.taint import boundaries

#: the entries with a volume account, and their modes (the reference's)
DEFAULT_ENTRIES = ("sgd", "delayed")
DEFAULT_MODES = ("off", "two_tree", "ring")


def step_volume(program) -> Dict[str, dict]:
    """``{"counts": {kind: n}, "bytes": {kind: b}, "total_bytes": b}`` of
    one step of a traced epoch (the whole program if it marks no step),
    bytes per party."""
    return _volume(program, collective=False)


def rank_volume(program) -> Dict[str, dict]:
    """:func:`step_volume`'s account of one rank's program on a device
    mesh: the model group's collectives of one step, bytes as this rank
    sends them."""
    return _volume(program, collective=True)


def _volume(program, collective: bool) -> Dict[str, dict]:
    found = boundaries(program)
    step = any(n.meta.get("step") for n in program.graph.nodes)
    counts: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    for b in found:
        if (step and not b.node.meta.get("step")) \
                or (collective and not b.collective):
            continue
        counts[b.kind] = counts.get(b.kind, 0) + 1
        nbytes[b.kind] = nbytes.get(b.kind, 0) + b.bytes_per_party
    return {"counts": dict(sorted(counts.items())),
            "bytes": dict(sorted(nbytes.items())),
            "total_bytes": sum(nbytes.values())}


def collective_volume(secure_modes: Sequence[str] = DEFAULT_MODES,
                      names: Sequence[str] = DEFAULT_ENTRIES,
                      device="cuda", indices=None,
                      progress: Optional[Callable[[str], None]] = None,
                      mesh=None, fixtures=None) -> Dict[str, dict]:
    """``{"<mode>/<entry>": step_volume}`` of the fixture's ``sgd`` and
    ``delayed`` (τ = ``entrypoints.TAU``) epochs; with ``mesh`` (a
    ``PartyMesh`` on a device mesh, every rank calling) this rank's
    :func:`rank_volume` of them.  ``fixtures``: a cache of engines, as in
    ``entrypoints.fixture``."""
    from repro_torch.analysis import entrypoints as ep

    entries = {e.name: e for e in ep.entries()}
    want = {"sgd": "sgd", "delayed": f"delayed{ep.TAU}"}
    count = step_volume if mesh is None else rank_volume
    out: Dict[str, dict] = {}
    for secure in secure_modes:
        fx = ep.fixture(secure, device, mesh, indices, fixtures)
        for name in names:
            if name not in want:
                continue
            if progress is not None:
                progress(f"volume {secure}/{name}")
            out[f"{secure}/{name}"] = count(
                entries[want[name]].trace(fx.eng, fx))
    return out
