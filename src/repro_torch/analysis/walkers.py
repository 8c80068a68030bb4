"""Walkers over the port's traced programs (``torch.fx`` graphs).

The counterpart of ``repro.analysis.walkers``, which counts primitives
recursively through nested jaxprs.  A program here is one flat
``fx.Graph`` of ATen nodes (``FusedEngine.party_program``, the serving
probes, or any ``make_fx`` trace), so the walkers are plain passes over
its nodes:

* host transfers: ``aten._local_scalar_dense`` / ``aten.item`` (a read of
  a device value on the host), ``aten.nonzero`` (a device-to-host read of
  its output size) and copies from the card to the CPU;
* cross-party operations: the party-axis boundaries that
  :mod:`repro_torch.analysis.taint` finds (reductions over dim 0 of a
  party-stacked tensor, permutations along it);
* the kernel census: ``repro_torch.vfl_grad`` nodes, each one launch of
  the kernel on the card;
* on a device mesh, the rank's model-group collectives: the c10d nodes
  (``c10d.allreduce_``, ``send``, ``recv_``, ``broadcast_``) not tagged
  with the data group (``secure_agg.trace_tag``).  A c10d node is no host
  transfer: where its backend stages a card's tensor through the host
  (gloo), that is the transport, not a read of the value;
* a histogram of node targets.

The census counts the nodes of one step (those an epoch trace marks with
``meta["step"]``): the counterpart of the reference's per-``scan``-body
counts.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

#: ops that read a device value on the host, or a device output's size
HOST_TRANSFER_OPS = frozenset({"aten._local_scalar_dense", "aten.item",
                               "aten.nonzero"})
#: ops that copy a tensor, checked for a card-to-CPU direction
COPY_OPS = frozenset({"aten._to_copy", "aten.to", "aten.copy_",
                      "aten.copy", "aten._copy_from"})
#: the operator each launch of the ``vfl_grad`` kernel dispatches through
VFL_GRAD_OP = "repro_torch.vfl_grad"


def _graph(program) -> torch.fx.Graph:
    return program.graph if hasattr(program, "graph") else program


def op_packet(node) -> str:
    """``"aten.sum"`` for a node of ``aten.sum.dim_IntList``; the name of a
    plain callable (``"getitem"``) otherwise; ``""`` for a node that calls
    nothing."""
    if node.op != "call_function":
        return ""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return str(packet)
    return getattr(target, "__name__", str(target))


def op_name(node) -> str:
    """``"aten.sum.dim_IntList"``: the node's overload, or its packet."""
    if node.op == "call_function" and hasattr(node.target, "overloadpacket"):
        return str(node.target)
    return op_packet(node)


def nodes(program, step_only: bool = False) -> Iterator:
    for node in _graph(program).nodes:
        if not step_only or node.meta.get("step"):
            yield node


def _device(val):
    dev = getattr(val, "device", None)
    return None if dev is None else torch.device(dev).type


def is_host_transfer(node) -> bool:
    """A host read, or a copy whose source is on the card and whose
    result is on the CPU."""
    packet = op_packet(node)
    if packet in HOST_TRANSFER_OPS:
        return True
    if packet not in COPY_OPS:
        return False
    out = _device(node.meta.get("val"))
    src = node.args[1] if packet in ("aten.copy_", "aten.copy") \
        else node.args[0]
    src = _device(src.meta.get("val")) if isinstance(src, torch.fx.Node) \
        else None
    return out == "cpu" and src not in (None, "cpu")


def count_host_transfers(program) -> int:
    return sum(is_host_transfer(n) for n in nodes(program))


def count_op(program, packet: str, step_only: bool = False) -> int:
    """Nodes whose op packet is ``packet`` (``"aten.roll"``,
    ``"repro_torch.vfl_grad"``)."""
    return sum(op_packet(n) == packet for n in nodes(program, step_only))


def vfl_grad_census(program) -> int:
    """``repro_torch.vfl_grad`` nodes in one step of an epoch program (the
    whole program if it marks no step): the kernel's launches a step makes
    on the card (``FusedEngine._StepLoop.per_step``)."""
    step = any(n.meta.get("step") for n in _graph(program).nodes)
    return count_op(program, VFL_GRAD_OP, step_only=step)


def is_model_collective(node) -> bool:
    """A c10d collective over the model group: tagged so, or untagged."""
    return op_packet(node).startswith("c10d.") and (
        node.meta.get("custom") or {}).get("collective", "model") == "model"


def count_model_collectives(program) -> int:
    """The model group's c10d collective nodes in a rank's program."""
    return sum(is_model_collective(n) for n in nodes(program))


def count_cross_party(program) -> int:
    """Party-axis boundaries (``taint.boundaries``) in the program."""
    from repro_torch.analysis.taint import boundaries
    return len(boundaries(program))


def target_histogram(program) -> Dict[str, int]:
    """Node count per op overload (``call_function`` nodes only)."""
    hist: Dict[str, int] = {}
    for node in nodes(program):
        if node.op == "call_function":
            name = op_name(node)
            hist[name] = hist.get(name, 0) + 1
    return dict(sorted(hist.items()))
