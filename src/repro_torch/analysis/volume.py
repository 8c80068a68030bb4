"""Per-step party-boundary volume, counted from the trace.

The counterpart of ``repro.analysis.volume``, which compiles selected
epochs on a real ("model",) mesh and reads the collectives of the
post-SPMD HLO.  The port runs its parties on one device, so there is no
collective to read: the volume is counted from the traced step instead.
Each party-axis boundary (``taint.boundaries``) of one step adds, per
party, its operand's elements that party holds times the dtype's size:
an aggregation of a (q, B) f32 partial moves 4·B bytes a party.  Kinds
follow the HLO names: a reduction is an ``all-reduce``, a permutation a
``collective-permute``, a prefix scan a ``scan``.  A permutation of mask
draws alone (the ring's ``roll``) stands in for a shared seed and moves
nothing (``taint``'s rule), so ``ring`` moves what ``off`` moves; the
two-tree form moves the masked sum and the mask sum.
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
    found = boundaries(program)
    step = any(n.meta.get("step") for n in program.graph.nodes)
    counts: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    for b in found:
        if step and not b.node.meta.get("step"):
            continue
        counts[b.kind] = counts.get(b.kind, 0) + 1
        nbytes[b.kind] = nbytes.get(b.kind, 0) + b.bytes_per_party
    return {"counts": dict(sorted(counts.items())),
            "bytes": dict(sorted(nbytes.items())),
            "total_bytes": sum(nbytes.values())}


def collective_volume(secure_modes: Sequence[str] = DEFAULT_MODES,
                      names: Sequence[str] = DEFAULT_ENTRIES,
                      device="cuda", indices=None,
                      progress: Optional[Callable[[str], None]] = None
                      ) -> Dict[str, dict]:
    """``{"<mode>/<entry>": step_volume}`` of the fixture's ``sgd`` and
    ``delayed`` (τ = ``entrypoints.TAU``) epochs."""
    from repro_torch.analysis import entrypoints as ep

    entries = {e.name: e for e in ep.entries()}
    want = {"sgd": "sgd", "delayed": f"delayed{ep.TAU}"}
    out: Dict[str, dict] = {}
    for secure in secure_modes:
        fx = ep.Fixture(secure, device, indices=indices)
        for name in names:
            if name not in want:
                continue
            if progress is not None:
                progress(f"volume {secure}/{name}")
            out[f"{secure}/{name}"] = step_volume(
                entries[want[name]].trace(fx.eng, fx))
    return out
