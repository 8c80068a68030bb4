"""Schedule audits: ring-buffer staleness proofs and storage identity.

The counterpart of ``repro.analysis.schedule``.

Staleness verifier
------------------
The delayed, faulted and guarded epochs carry per-party gradient **rings**
of τ+1 slots along dim 1 of a loop buffer (q, τ+1, ...): step t writes
slot ``t mod (τ+1)`` with ``index_copy_`` and reads slot
``max(t − d, 0) mod (τ+1)`` with ``gather``.  The bounded-staleness claim
— no read is older than τ — holds if (1) the ring has τ+1 slots, (2) the
step writes its slot before any read, and (3) every index lies in
[0, τ].  :func:`ring_audit` proves (1)–(3) on one traced step (the nodes
``FusedEngine.tracing`` marks) with an interval interpretation of the
index arithmetic (``add``/``sub``/``mul``, ``remainder``, ``clamp_min``,
``where``, the views).  Precondition, as in the reference: integer
program inputs (the step counter, the delays) are nonnegative, which
``core.staleness``/``core.faults`` check at the API.  Unknown ops give
(−∞, ∞), which fails the proof.

A faulted ring's write is **gated**: the value written is
``where(alive, new, ring[slot])``, the slot's old value read back for a
party that received no ϑ (a crash is an unbounded delay by design, so
the bound holds conditional on liveness).  That read is the gate, not a
staleness read.  The port's deep epochs keep the three encoder rings as
one flat ring (``engine._ring_flat``), so a deep entry reports one ring
where the reference reports three; the verdicts are the same.

Storage identity
----------------
The reference audits that XLA honours the donation of a chained epoch's
buffers.  The port's epochs update their loop's static buffers in place,
so :func:`storage_audit` checks the equivalent: a second epoch of the same
kind and schedule shape reuses the first one's loop (the same
``_StepLoop`` and buffer data pointers), captures no new CUDA graph, and
leaves no device memory allocated beyond the tensors it returns (on the
card; the CPU has no allocator count, and reports None).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import fx

from repro_torch.analysis.walkers import op_packet

_INF = math.inf
Interval = Tuple[float, float]

# ops through which an index keeps its interval
_PASS = {"aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand",
         "aten.expand_as", "aten.unsqueeze", "aten.squeeze", "aten.clone",
         "aten._to_copy", "aten.to", "aten.alias", "aten.select",
         "aten.slice", "aten.permute", "aten.transpose", "aten.t",
         "aten.contiguous", "aten.lift_fresh_copy", "aten.detach",
         "aten.flatten", "aten.index_select", "aten.gather", "aten.amax",
         "aten.amin", "aten.index", "aten.repeat"}
_VIEWS = {"aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand",
          "aten.expand_as", "aten.unsqueeze", "aten.squeeze", "aten.alias",
          "aten.clone", "aten.contiguous", "aten.permute", "aten.transpose"}


def _cmp(a: Interval, b: Interval, op: str) -> Interval:
    """A comparison's verdict: (0, 0) false, (1, 1) true, (0, 1) unknown."""
    (lo_a, hi_a), (lo_b, hi_b) = a, b
    true = {"lt": hi_a < lo_b, "le": hi_a <= lo_b, "gt": lo_a > hi_b,
            "ge": lo_a >= hi_b, "eq": lo_a == hi_a == lo_b == hi_b,
            "ne": hi_a < lo_b or hi_b < lo_a}[op]
    false = {"lt": lo_a >= hi_b, "le": lo_a > hi_b, "gt": hi_a <= lo_b,
             "ge": hi_a < lo_b, "eq": hi_a < lo_b or hi_b < lo_a,
             "ne": lo_a == hi_a == lo_b == hi_b}[op]
    return (1.0, 1.0) if true else (0.0, 0.0) if false else (0.0, 1.0)


class Intervals:
    """Forward interval analysis of a traced program's integer arithmetic.

    Integer placeholders are assumed nonnegative (the documented
    precondition); an integer constant takes its values' range; a
    literal is exact.  ``get(node)`` is the node's interval."""

    def __init__(self, program):
        self.gm = program
        graph = program.graph if hasattr(program, "graph") else program
        self.env: Dict[str, Interval] = {}
        for node in graph.nodes:
            self.env[node.name] = self._node(node)

    def get(self, atom) -> Interval:
        if isinstance(atom, fx.Node):
            return self.env.get(atom.name, (-_INF, _INF))
        if isinstance(atom, bool):
            return (float(atom), float(atom))
        if isinstance(atom, (int, float)):
            return (float(atom), float(atom))
        return (-_INF, _INF)

    def _node(self, node) -> Interval:
        if node.op == "placeholder":
            val = node.meta.get("val")
            if isinstance(val, torch.Tensor) and not val.is_floating_point() \
                    and val.dtype != torch.bool:
                return (0.0, _INF)
            return (-_INF, _INF)
        if node.op == "get_attr":
            val = getattr(self.gm, node.target, None)
            if isinstance(val, torch.Tensor) and val.numel() \
                    and not val.is_floating_point() and val.numel() <= 4096:
                return (float(val.min()), float(val.max()))
            return (-_INF, _INF)
        if node.op != "call_function":
            return (-_INF, _INF)
        packet = op_packet(node)
        a = node.args
        ins = [self.get(x) for x in a]
        if packet == "aten.add" or packet == "aten.add_":
            alpha = node.kwargs.get("alpha", 1)
            lo_b, hi_b = sorted((ins[1][0] * alpha, ins[1][1] * alpha))
            return (ins[0][0] + lo_b, ins[0][1] + hi_b)
        if packet == "aten.sub" or packet == "aten.sub_":
            return (ins[0][0] - ins[1][1], ins[0][1] - ins[1][0])
        if packet == "aten.mul":
            c = [x * y for x in ins[0] for y in ins[1] if not math.isnan(x * y)]
            return (min(c), max(c)) if c else (-_INF, _INF)
        if packet == "aten.neg":
            return (-ins[0][1], -ins[0][0])
        if packet == "aten.remainder":
            lo, hi = ins[1]
            if lo > 0 and hi != _INF:      # floor mod: the divisor's sign
                return (0.0, hi - 1)
            return (-_INF, _INF)
        if packet == "aten.fmod":
            lo, hi = ins[1]
            if lo > 0 and hi != _INF:      # C mod: the dividend's sign
                return (0.0, hi - 1) if ins[0][0] >= 0 else (1 - hi, hi - 1)
            return (-_INF, _INF)
        if packet == "aten.clamp_min":
            return (max(ins[0][0], ins[1][0]), max(ins[0][1], ins[1][0]))
        if packet == "aten.clamp_max":
            return (min(ins[0][0], ins[1][1]), min(ins[0][1], ins[1][1]))
        if packet == "aten.clamp":
            lo = ins[1] if len(ins) > 1 and a[1] is not None else (-_INF,) * 2
            hi = ins[2] if len(ins) > 2 and a[2] is not None else (_INF,) * 2
            return (min(max(ins[0][0], lo[0]), hi[1]),
                    min(max(ins[0][1], lo[0]), hi[1]))
        if packet == "aten.maximum":
            return (max(ins[0][0], ins[1][0]), max(ins[0][1], ins[1][1]))
        if packet == "aten.minimum":
            return (min(ins[0][0], ins[1][0]), min(ins[0][1], ins[1][1]))
        if packet in ("aten.lt", "aten.le", "aten.gt", "aten.ge", "aten.eq",
                      "aten.ne"):
            return _cmp(ins[0], ins[1], packet.split(".")[1])
        if packet == "aten.where":
            lo_w, hi_w = ins[0]
            if lo_w == hi_w:
                return ins[1] if lo_w else ins[2]
            return (min(ins[1][0], ins[2][0]), max(ins[1][1], ins[2][1]))
        if packet == "aten.arange":
            ends = [x for x in a if isinstance(x, (int, float))]
            if len(ends) == 1:
                return (0.0, float(ends[0]) - 1)
            if len(ends) >= 2:
                return (float(ends[0]), float(ends[1]) - 1)
        if packet in ("aten.zeros", "aten.zeros_like", "aten.new_zeros"):
            return (0.0, 0.0)
        if packet in _PASS:
            return ins[0]
        return (-_INF, _INF)


@dataclasses.dataclass
class RingAudit:
    """Verdict for one ring buffer of one traced step."""

    buffer: str              # the loop buffer's name
    length: int              # ring slots (must be tau + 1)
    writes: int              # index_copy_ writes per step
    reads: int               # gather / index_select reads per step
    gated: bool              # the write is liveness-gated (faulted epochs)
    write_in_range: bool     # every write index provably in [0, len-1]
    reads_in_range: bool     # every read index provably in [0, len-1]
    write_before_read: bool  # program order: the write precedes every read
    notes: List[str]

    @property
    def bounded(self) -> bool:
        """τ-bounded staleness holds (conditional on liveness if gated)."""
        return (self.writes >= 1 and self.write_in_range
                and self.reads_in_range and self.write_before_read)

    def to_dict(self) -> dict:
        return {"buffer": self.buffer, "length": self.length,
                "writes": self.writes, "reads": self.reads,
                "gated": self.gated, "bounded": self.bounded,
                "notes": self.notes}


def _roots(graph) -> Dict[str, str]:
    """Each node's storage root: a view's input's root, an in-place op's
    written argument's root, else the node itself."""
    root: Dict[str, str] = {}
    for node in graph.nodes:
        root[node.name] = node.name
        schema = getattr(node.target, "_schema", None)
        if node.op != "call_function" or schema is None:
            continue
        for i, arg in enumerate(schema.arguments):
            src = node.args[i] if i < len(node.args) else None
            if arg.alias_info is None or not isinstance(src, fx.Node):
                continue
            if arg.alias_info.is_write or (
                    schema.returns and schema.returns[0].alias_info):
                root[node.name] = root[src.name]
            break
    return root


def _strip(node):
    """Follow a value back through views to the node that made it."""
    while isinstance(node, fx.Node) and op_packet(node) in _VIEWS:
        node = node.args[0]
    return node


def _ring_read(node, roots, ring: str) -> Optional[fx.Node]:
    """The index node of a read along dim 1 of ``ring``, if ``node`` is one."""
    packet = op_packet(node)
    if packet in ("aten.gather", "aten.index_select") \
            and isinstance(node.args[0], fx.Node) \
            and roots[node.args[0].name] == ring and node.args[1] == 1:
        return node.args[2]
    if packet == "aten.index" and isinstance(node.args[0], fx.Node) \
            and roots[node.args[0].name] == ring:
        idx = node.args[1]
        if len(idx) > 1 and idx[0] is None and idx[1] is not None:
            return idx[1]
    return None


def ring_audit(program, tau: int) -> List[RingAudit]:
    """Audit every (τ+1)-slot ring of one traced step.

    A ring is a loop buffer (placeholder) whose dim 1 has τ+1 slots and
    that the step writes with ``index_copy_`` along dim 1.  Returns one
    audit per ring; ``bounded=False`` is a staleness violation."""
    graph = program.graph if hasattr(program, "graph") else program
    order = [n for n in graph.nodes]
    step = [n for n in order if n.meta.get("step")] or order
    pos = {n.name: i for i, n in enumerate(step)}
    roots = _roots(graph)
    iv = Intervals(program)
    audits: List[RingAudit] = []
    for buf in (n for n in order if n.op == "placeholder"):
        val = buf.meta.get("val")
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
        if len(shape) < 2 or shape[1] != tau + 1:
            continue
        writes, gates, reads = [], set(), []
        for node in step:
            if op_packet(node) in ("aten.index_copy_", "aten.index_copy") \
                    and isinstance(node.args[0], fx.Node) \
                    and roots[node.args[0].name] == buf.name \
                    and node.args[1] == 1:
                writes.append((pos[node.name], iv.get(node.args[2])))
                src = _strip(node.args[3])
                if op_packet(src) == "aten.where":
                    for branch in src.args[1:3]:
                        branch = _strip(branch)
                        if isinstance(branch, fx.Node) \
                                and _ring_read(branch, roots, buf.name) \
                                is not None:
                            gates.add(branch.name)
        if not writes:
            continue
        for node in step:
            idx = _ring_read(node, roots, buf.name)
            if idx is not None and node.name not in gates:
                reads.append((pos[node.name], iv.get(idx)))
        length = shape[1]
        notes: List[str] = []
        write_ok = True
        for _, (lo, hi) in writes:
            if not (lo >= 0 and hi <= length - 1):
                write_ok = False
                notes.append(f"write index interval [{lo}, {hi}] not "
                             f"within [0, {length - 1}]")
        reads_ok = True
        for _, (lo, hi) in reads:
            if not (lo >= 0 and hi <= length - 1):
                reads_ok = False
                notes.append(f"read index interval [{lo}, {hi}] not within "
                             f"[0, {length - 1}]")
        first = min(p for p, _ in writes)
        order_ok = all(p > first for p, _ in reads)
        if gates:
            notes.append("write liveness-gated: bound holds conditional on "
                         "liveness (crash = unbounded delay, by design)")
        audits.append(RingAudit(buf.meta.get("buffer", buf.name), length,
                                len(writes), len(reads), bool(gates),
                                write_ok, reads_ok, order_ok, notes))
    return audits


@dataclasses.dataclass
class StorageAudit:
    """A second epoch of one kind and shape against the first."""

    loops: int                   # step loops after the first epoch
    same_loop: bool              # no new loop, the same _StepLoop objects
    same_storage: bool           # every loop buffer at the same address
    same_graph: bool             # no new CUDA graph captured
    allocated_bytes: Optional[int]  # device bytes left behind (None: CPU)

    @property
    def ok(self) -> bool:
        return (self.same_loop and self.same_storage and self.same_graph
                and self.allocated_bytes in (None, 0))

    def to_dict(self) -> dict:
        return {"loops": self.loops, "same_loop": self.same_loop,
                "same_storage": self.same_storage,
                "same_graph": self.same_graph,
                "allocated_bytes": self.allocated_bytes, "ok": self.ok}


def _snapshot(eng):
    return {key: (id(loop), {k: v.data_ptr() for k, v in loop.bufs.items()},
                  id(loop.graph))
            for key, loop in eng._loops.items()}


def _nbytes(out) -> int:
    """Device bytes the caching allocator holds for ``out``'s tensors (each
    block rounded up to its 512-byte granule)."""
    if isinstance(out, torch.Tensor):
        return -(-out.numel() * out.element_size() // 512) * 512
    if isinstance(out, (tuple, list)):
        return sum(_nbytes(o) for o in out)
    return 0


def storage_audit(eng, epoch) -> StorageAudit:
    """Run ``epoch()`` (one epoch call on ``eng``) twice and compare the
    engine's step loops after each; on the card also count the device
    memory the second call leaves allocated beyond its outputs."""
    epoch()
    first = _snapshot(eng)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(eng.device)
        before = torch.cuda.memory_allocated(eng.device)
    out = epoch()
    left = None
    if cuda:
        torch.cuda.synchronize(eng.device)
        left = torch.cuda.memory_allocated(eng.device) - before - _nbytes(out)
    second = _snapshot(eng)
    same_loop = first.keys() == second.keys() and all(
        first[k][0] == second[k][0] for k in first)
    return StorageAudit(
        len(first), same_loop,
        same_loop and all(first[k][1] == second[k][1] for k in first),
        same_loop and all(first[k][2] == second[k][2] for k in first),
        left)
