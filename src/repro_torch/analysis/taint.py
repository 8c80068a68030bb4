"""Leakage taint analysis over the port's traced programs (paper Definition 4).

The counterpart of ``repro.analysis.taint``.  The property is the same:
**no value derived from a party's private features crosses a party
boundary without a per-party mask offset.**  The reference proves it over a
per-party jaxpr whose boundaries are named-axis collectives.  The port has
no per-party program: the q parties are dim 0 of every party-stacked
tensor on one device (``core.secure_agg``), so a program is one
``torch.fx`` graph of ATen nodes (``FusedEngine.party_program``, the
serving probes, a mutant's trace) and the boundary rule is stated on that
axis.

**Party dimensions.**  Every value carries, per dimension, the number of
party groups along it (0: not a party dimension).  The declared inputs
seed it: a loop buffer's ``meta["party_dims"]``, a constant's entry in
``gm.meta["consts"]``.  Shape operations carry it — a view that merges the
party axis with later dimensions keeps it as the merged dimension's outer
factor, a view that splits it (``_inner_major``'s slots × parties-per-slot)
marks both factors, a transpose moves it — and a broadcast (``expand``)
adds none: a value expanded over q is the same for every party.

**Boundaries** (``boundaries``), at which a value leaves its party:

* a reduction (``sum``, ``amax``, ``all``, ...; a prefix scan; a
  contraction of ``bmm``/``mm``/``mv`` or ``repro_torch.vfl_grad``) over a
  party dimension — the aggregations, and the two-level form's two
  levels — or over dim 0 of a tensor derived from mask draws alone (the
  two-tree form's ξ₂ = Σδ, whose draw carries no declared party axis);
* a permutation along a party dimension: ``roll``, ``flip``, and a
  gather (``index``, ``index_select``, ``gather``) along it (the trees'
  round indices of ``schedule_faithful``).  A permutation that acts only
  on mask draws (the ring's ``r − roll(r)``, the survivor ring's table
  gather) stands in for a pairwise shared seed and is not a message, as
  the reference derives its ring masks from keys; a gather from the
  feature block itself (the step's minibatch rows) is the party's own
  selection.

**On a device mesh** (``PartyMesh(mesh=DeviceMesh)``) a program is one
rank's: its qloc party rows, and its messages the c10d collectives
``make_fx`` records.  Each carries its call site's tags
(``secure_agg.trace_tag``, in ``meta["custom"]``):

* the c10d rule (``Analyzer._c10d``): over the model group an
  ``allreduce_`` is an ``all-reduce`` boundary on its operand (its
  result flows on through the ``getitem``s), a ``send`` a
  ``collective-permute`` boundary on the sent operand and a
  ``broadcast_`` a ``collective-broadcast`` boundary; a ``recv_`` and a
  ``broadcast_`` write their buffer in place, and later reads of it come
  from the collective (the in-place-write rule below).  A collective
  over the data group (the data shards of the same parties) is a plain
  sum.  A c10d op with no rule fails closed: a boundary on each operand,
  and recorded in ``Analyzer.unknown``.  At a collective the tainted
  operand's stream must also differ from rank to rank
  (``RANK_DISTINCT``): a draw from the rank's own party stream (stacked
  over its parties, one stream distinct along them where each row's tag
  names another party), its slot's stream
  or a row of the counter stream (``secure_agg._counter_normal``, one
  draw whose rows are the survivor ranks); the ring's ``prev`` draw is
  the rank before's own, the shared seed of a pair, as the one-device
  ``roll`` rule has it.
* the release rule: the model-group ``broadcast_`` tagged
  ``release=SERVED_ANSWER`` is the served answer leaving slot 0's rank
  (the reference computes it outside the program it lints); it is
  counted (``Analyzer.released``) and its value public.  Any other
  broadcast of a tainted value is a boundary as above.
* the seed check (:func:`seed_findings`): seeds are runtime values no
  trace holds, so the linter gathers every rank's ``(role, level, index,
  initial seed)`` after the same ``seed(*key)`` and requires own-party
  seeds pairwise distinct over the q parties, slot seeds distinct over
  the slots and each rank's ``prev`` equal to its neighbour's own seed;
  a violation is ``mask-not-party-distinct``.

Selecting one row of a party-stacked tensor (``head[0]``, the tree's root
``acc[0]``) reads state every party holds (the replicated head) or the
result of the boundary just crossed; it is not a boundary.

**Taint** starts at the party's feature block, the engine's ``xs``, which
``make_fx`` records as a ``get_attr`` constant (closed over, not an
input): ``core.engine.trace_program`` names it by tensor identity in
``gm.meta["consts"]``, and the analysis marks that constant as the
source.  Taint propagates by union through every node, and through
in-place writes into the written tensor (a loop buffer written by one
step is read by the next: the writes are iterated to a fixpoint, the
counterpart of the reference's ``scan`` carry fixpoint).

**Masks.**  Each ``randn``/``normal`` draw starts a stream.  A stream
records, per dimension of the value it reaches, how many distinct draws
lie along it: a draw over (q, B) is distinct along both, one expanded
over q is not distinct along the party axis.  At a boundary, a tainted
operand must carry a stream distinct along every party dimension of the
operand (both levels' factors under the two-level view).

**Findings.**

* ``unmasked-boundary``: a tainted operand with no mask stream;
* ``mask-not-party-distinct``: masked, but no stream is distinct along
  every party dimension (equal-seeded masks cancel in the aggregator's
  view);
* ``mask-feeds-two-aggregations`` (the membership rule, for entries
  analysed with ``membership=True``): one draw reaches the operands of
  two aggregations (tainted reductions) without crossing a boundary in
  between.  The reference re-keys each mask stream from the alive set's
  fingerprint (``mask-not-membership-keyed``); the port draws every
  aggregation's masks fresh from the step's generator, so a step has one
  membership set per draw, and the property to hold is that no draw
  serves two aggregations (two membership sets).

**Declassification.**  The finiteness verdict of a value is
protocol-public, as in the reference's ``is_finite`` rule: a masked
message is non-finite iff the raw partial is.  ``torch.isfinite`` traces
as ``x == x`` and ``|x| != inf``; those comparisons (and ``isnan``'s
``x != x``, ``isinf``'s ``|x| == inf``) drop taint and keep the mask
provenance.  The same caveat as the reference's applies.

Soundness stance: a linter, not a proof.  Taint and streams propagate by
union through unknown ops (recorded in ``Analyzer.unknown``), so a
nonlinear op that destroys additive masking can launder a value; the
mutants of :mod:`repro_torch.analysis.mutants` pin the failure modes
that matter.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
from torch import fx

from repro_torch.analysis.walkers import op_packet
from repro_torch.core.secure_agg import SERVED_ANSWER

Ann = Tuple[int, ...]

UNMASKED = "unmasked-boundary"
EQUAL_SEEDED = "mask-not-party-distinct"
MASK_REUSED = "mask-feeds-two-aggregations"

#: the stream roles whose draws differ from rank to rank of the model
#: group: a party's own stream, its slot's, the counter stream's row of
#: the member's survivor rank (the ring's ``prev`` stream is the rank
#: before's own, the shared seed of a pair)
RANK_DISTINCT = frozenset({"own", "slot", "counter"})
#: the c10d collectives with a rule; any other fails closed
_C10D = {"c10d.allreduce_", "c10d.send", "c10d.recv_", "c10d.broadcast_"}


@dataclasses.dataclass(frozen=True)
class Stream:
    """A mask draw in a value's provenance: the draw node's name, the
    number of distinct draws along each of the value's dimensions,
    whether it has yet to cross a boundary, and, on a device mesh, the
    role of the stream it came from (``"own"``, ``"slot"``, ``"prev"``,
    ``"counter"``; None for a draw from no declared stream) and that
    stream's party or slot index (None where the tag gives none)."""

    draw: str
    var: Ann
    fresh: bool = True
    role: Optional[str] = None
    index: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Props:
    """Abstract state of one traced value."""

    taint: bool = False          # derives from a party's private features
    source: bool = False         # a view of the feature block itself
    party: Ann = ()              # party groups along each dimension
    streams: FrozenSet[Stream] = frozenset()

    @property
    def mask_only(self) -> bool:
        return not self.taint and bool(self.streams)

    def mapped(self, fn) -> "Props":
        """The same state through a shape map ``fn`` (Ann -> Ann)."""
        return Props(self.taint, self.source, fn(self.party),
                     frozenset(dataclasses.replace(s, var=fn(s.var))
                               for s in self.streams))


@dataclasses.dataclass(frozen=True)
class TaintFinding:
    """One leakage violation at a party boundary."""

    code: str
    op: str           # the boundary's ATen op
    node: str         # the boundary node's name
    detail: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.op} @ {self.node}: {self.detail}"


@dataclasses.dataclass
class Boundary:
    """One party-axis crossing: its node, kind (``"all-reduce"``,
    ``"scan"``, ``"collective-permute"`` or ``"collective-broadcast"``),
    the operand's state, shape and dtype, the party groups the crossing
    spans, and whether it is a collective over the model group of a
    device mesh (a c10d node: the operand is this rank's, every byte of
    it sent)."""

    node: fx.Node
    kind: str
    props: Props
    shape: Tuple[int, ...]
    dtype: torch.dtype
    groups: int
    collective: bool = False

    @property
    def bytes_per_party(self) -> int:
        """The operand's elements one party holds, times the dtype's
        size: what each party sends through this boundary."""
        numel = math.prod(self.shape)
        return numel // max(self.groups, 1) * _itemsize(self.dtype)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# shape maps of the per-dimension annotations
# ---------------------------------------------------------------------------

def _zeros(n: int) -> Ann:
    return (0,) * n


def _crossing(a: int) -> bool:
    """A dimension of ``a`` party groups crosses parties if it holds two
    or more (a device mesh rank's one party row is one party)."""
    return a > 1


def _bcast(ann: Ann, src, dst) -> Ann:
    """Right-aligned broadcast of ``src``-shaped ``ann`` to ``dst``: a
    size-1 dimension stretched over many, and a new leading dimension,
    carry nothing; a dimension of another size keeps its count, capped."""
    out = [0] * len(dst)
    off = len(dst) - len(src)
    for i, (a, s) in enumerate(zip(ann, src)):
        j = i + off
        if j < 0:
            continue
        out[j] = 0 if (s == 1 and dst[j] != 1) else min(a, dst[j])
    return tuple(out)


def _outer(anns, sizes) -> int:
    """Party groups of a block of merged dimensions, party-major: the
    product of the leading marked factors; a marked dimension inside an
    unmarked one makes every element its own group (conservative)."""
    count, marked = 1, False
    for k, (a, s) in enumerate(zip(anns, sizes)):
        rest = any(anns[k + 1:])
        if a == 0:
            return math.prod(sizes) if rest else (count if marked else 0)
        marked = True
        count *= a
        if a < s:
            return math.prod(sizes) if rest else count
    return count if marked else 0


def _view(ann: Ann, src, dst) -> Ann:
    """A reshape of ``src`` to ``dst``: dimensions are matched in blocks of
    equal size; a block's party groups fill its output dimensions from the
    outermost in."""
    src, dst = list(src), list(dst)
    out = [0] * len(dst)
    i = j = 0
    try:
        while True:
            while i < len(src) and src[i] == 1:
                i += 1
            while j < len(dst) and dst[j] == 1:
                j += 1
            if i >= len(src) or j >= len(dst):
                break
            gi, gj = [i], [j]
            ps, pd = src[i], dst[j]
            i, j = i + 1, j + 1
            while ps != pd:
                if ps < pd:
                    ps *= src[i]
                    gi.append(i)
                    i += 1
                else:
                    pd *= dst[j]
                    gj.append(j)
                    j += 1
            rem = _outer([ann[k] for k in gi], [src[k] for k in gi])
            for k in gj:
                if rem <= 1:
                    break
                out[k] = min(rem, dst[k])
                rem = -(-rem // dst[k])
    except IndexError:                # sizes that do not match: no claim
        return _zeros(len(dst))
    return tuple(out)


def _drop(ann: Ann, dims, keepdim: bool) -> Ann:
    if keepdim:
        return tuple(0 if d in dims else a for d, a in enumerate(ann))
    return tuple(a for d, a in enumerate(ann) if d not in dims)


def _cap(ann: Ann, shape) -> Ann:
    return tuple(min(a, s) for a, s in zip(ann, shape))


def _join(a: Props, b: Props) -> Props:
    """Union of two states of one shape."""
    party = tuple(max(x, y) for x, y in zip(a.party, b.party)) \
        if len(a.party) == len(b.party) else a.party
    return Props(a.taint or b.taint, a.source and b.source, party,
                 a.streams | b.streams)


def _norm_dims(dims, ndim: int) -> Tuple[int, ...]:
    if ndim == 0:
        return ()
    if dims is None:
        return tuple(range(ndim))
    if isinstance(dims, int):
        dims = [dims]
    dims = [d % ndim if ndim else 0 for d in dims]
    return tuple(sorted(set(dims))) if dims else tuple(range(ndim))


# ---------------------------------------------------------------------------
# op tables
# ---------------------------------------------------------------------------

_IDENTITY = {"aten.alias", "aten.clone", "aten.contiguous", "aten.detach",
             "aten.lift_fresh_copy", "aten.lift_fresh", "aten._to_copy",
             "aten.to", "aten.type_as", "aten.positive"}
_RESHAPE = {"aten.view", "aten._unsafe_view", "aten.reshape",
            "aten._reshape_alias", "aten.flatten", "aten.unflatten",
            "aten.view_as", "aten.reshape_as"}
_EXPAND = {"aten.expand", "aten.expand_as", "aten.broadcast_to"}
_REDUCE = {"aten.sum", "aten.mean", "aten.amax", "aten.amin", "aten.max",
           "aten.min", "aten.all", "aten.any", "aten.prod",
           "aten.logsumexp", "aten.linalg_vector_norm", "aten.norm",
           "aten.var", "aten.std", "aten.argmax", "aten.argmin",
           "aten.count_nonzero", "aten.nansum", "aten.var_mean"}
_SCAN = {"aten.cumsum", "aten.cumprod", "aten.cummax", "aten.cummin",
         "aten.logcumsumexp"}
_DRAW = {"aten.randn", "aten.normal", "aten.rand", "aten.randn_like",
         "aten.rand_like", "aten.normal_", "aten.uniform_"}
_CREATE = {"aten.zeros", "aten.ones", "aten.empty", "aten.full",
           "aten.arange", "aten.scalar_tensor", "aten.zeros_like",
           "aten.ones_like", "aten.empty_like", "aten.full_like",
           "aten.new_zeros", "aten.new_ones", "aten.new_empty",
           "aten.new_full", "aten.empty_strided", "aten.randint",
           "aten.randperm", "aten.eye", "aten.linspace", "aten.fill_",
           "aten.zero_"}
_CONTRACT = {"aten.bmm": ("bnk", "bkm", "bnm"), "aten.mm": ("nk", "km", "nm"),
             "aten.mv": ("nk", "k", "n"), "aten.dot": ("k", "k", ""),
             "aten.vdot": ("k", "k", "")}
_ADD_CONTRACT = {"aten.addmm": "aten.mm", "aten.baddbmm": "aten.bmm",
                 "aten.addmv": "aten.mv"}


def _shape(node) -> Optional[Tuple[int, ...]]:
    val = node.meta.get("val") if isinstance(node, fx.Node) else node
    if isinstance(val, torch.Tensor):
        return tuple(int(s) for s in val.shape)
    return None


def _dtype(node):
    val = node.meta.get("val")
    return val.dtype if isinstance(val, torch.Tensor) else torch.float32


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

class Analyzer:
    """Abstract interpretation of one program: ``run()`` fills
    ``findings``, ``boundaries`` and ``unknown`` (the op packets it had no
    rule for)."""

    def __init__(self, program, membership: bool = False,
                 sources: Sequence[str] = ()):
        self.gm = program
        self.graph = program.graph if hasattr(program, "graph") else program
        self.membership = membership
        self.sources = set(sources)
        meta = getattr(program, "meta", {}) or {}
        self.consts = dict(meta.get("consts", {}))
        self.findings: List[TaintFinding] = []
        self.boundaries: List[Boundary] = []
        self.unknown: set = set()
        self.released = 0                     # served answers broadcast
        self._emit = False
        self._writes: Dict[str, Props] = {}
        self._fed: Dict[str, str] = {}        # draw -> first aggregation
        self._shapes = {n.name: self._node_shape(n) for n in self.graph.nodes}

    def _node_shape(self, node):
        if node.op == "get_attr":
            val = getattr(self.gm, node.target, None)
            return tuple(val.shape) if isinstance(val, torch.Tensor) else None
        return _shape(node)

    # -- the fixpoint ----------------------------------------------------------

    def run(self) -> "Analyzer":
        for _ in range(32):
            before = dict(self._writes)
            self._walk()
            if self._writes == before:
                break
        self._emit = True
        self._walk()
        return self

    def _walk(self):
        self.env: Dict[str, object] = {}
        self.root: Dict[str, str] = {}
        for node in self.graph.nodes:
            self.root[node.name] = node.name
            out = self._node(node)
            if out is not None:
                self.env[node.name] = out

    # -- helpers ---------------------------------------------------------------

    def _get(self, arg) -> Optional[Props]:
        if isinstance(arg, fx.Node):
            p = self.env.get(arg.name)
            return p if isinstance(p, Props) else None
        return None

    def _base(self, node, props: Props) -> Props:
        """A root's state with what later writes put into it."""
        w = self._writes.get(node.name)
        if w is None:
            return props
        return Props(props.taint or w.taint, props.source, props.party,
                     props.streams | w.streams)

    def _boundary(self, node, kind: str, props: Props, shape, dims,
                  aggregation: bool, operand=None,
                  collective: bool = False) -> bool:
        """Record a crossing (on the last walk) and check its operand;
        returns whether a party-private operand crossed unmasked (its
        result is then not checked again: the leak is reported once)."""
        unmasked = props.taint and not props.streams
        if not self._emit:
            return unmasked
        marked = [props.party[d] for d in dims if _crossing(props.party[d])]
        groups = 1 if collective else math.prod(marked) if marked \
            else math.prod(shape[d] for d in dims)
        dtype = _dtype(node.args[0] if operand is None else operand)
        self.boundaries.append(Boundary(node, kind, props, tuple(shape),
                                        dtype, groups, collective))
        if not props.taint:
            return False
        op = op_packet(node)
        pdims = [d for d, a in enumerate(props.party) if _crossing(a)]
        if unmasked:
            self._find(UNMASKED, op, node,
                       "party-private operand crosses the boundary with no "
                       "mask draw in its provenance")
            return True
        if not any(all(s.var[d] >= props.party[d] for d in pdims)
                   for s in props.streams):
            self._find(EQUAL_SEEDED, op, node,
                       f"no mask stream is distinct along every party "
                       f"dimension {pdims} of the operand (a draw repeated "
                       f"over parties cancels in the aggregator's view)")
        elif collective and not any(s.role in RANK_DISTINCT
                                    for s in props.streams):
            self._find(EQUAL_SEEDED, op, node,
                       "no mask stream of the operand differs from rank to "
                       "rank of the model group (a draw from no party's or "
                       "slot's own stream is the same on every rank)")
        if self.membership and aggregation:
            for s in props.streams:
                if not s.fresh:
                    continue
                first = self._fed.setdefault(s.draw, node.name)
                if first != node.name:
                    self._find(MASK_REUSED, op, node,
                               f"mask draw {s.draw} also feeds the "
                               f"aggregation at {first} (one draw serves "
                               f"two membership sets)")

    def _find(self, code, op, node, detail):
        f = TaintFinding(code, op, node.name, detail)
        if f not in self.findings:
            self.findings.append(f)

    @staticmethod
    def _crossed(props: Props, leaked: bool = False) -> Props:
        """The result of a crossing: its streams no longer fresh; its
        taint dropped where the crossing already reported it unmasked
        (the two levels of an unmasked two-level sum are one leak)."""
        return Props(props.taint and not leaked, False, props.party,
                     frozenset(dataclasses.replace(s, fresh=False)
                               for s in props.streams))

    # -- transfer ------------------------------------------------------------

    def _node(self, node):
        if node.op == "placeholder":
            shape = _shape(node) or ()
            dims = node.meta.get("party_dims", ())
            party = tuple(shape[d] if d in dims else 0
                          for d in range(len(shape)))
            return self._base(node, Props(
                taint=(node.name in self.sources
                       or node.meta.get("buffer") in self.sources),
                party=party))
        if node.op == "get_attr":
            val = getattr(self.gm, node.target, None)
            if not isinstance(val, torch.Tensor):
                return None
            shape = tuple(val.shape)
            dims, source = self.consts.get(node.target, ((), False))
            party = tuple(shape[d] if d in dims else 0
                          for d in range(len(shape)))
            return self._base(node, Props(taint=source, source=source,
                                          party=party))
        if node.op != "call_function":
            return None
        if node.target is operator.getitem:
            seq = self.env.get(node.args[0].name)
            self.root[node.name] = self.root.get(node.args[0].name,
                                                 node.name)
            if isinstance(seq, (tuple, list)):
                return seq[node.args[1]]
            return None
        out = self._transfer(node)
        schema = getattr(node.target, "_schema", None)
        if schema is not None:
            self._aliases(node, schema, out)
        if isinstance(out, Props) and self.root[node.name] == node.name:
            out = self._base(node, out)
        return out

    def _aliases(self, node, schema, out):
        """Record a view's root; join an in-place op's result into the
        root of the tensor it writes."""
        for i, arg in enumerate(schema.arguments):
            info = arg.alias_info
            if info is None or i >= len(node.args):
                continue
            src = node.args[i]
            if not isinstance(src, fx.Node):
                continue
            if info.is_write:
                root = self.root.get(src.name, src.name)
                self.root[node.name] = root
                if isinstance(out, Props):
                    rshape = self._shapes.get(root) or ()
                    same = self._shapes.get(src.name) == rshape
                    prev = self._writes.get(root, Props())
                    self._writes[root] = Props(
                        prev.taint or out.taint, False, (),
                        prev.streams | frozenset(
                            s if same else dataclasses.replace(
                                s, var=_zeros(len(rshape)))
                            for s in out.streams))
                return
            if schema.returns and schema.returns[0].alias_info is not None:
                self.root[node.name] = self.root.get(src.name, src.name)
                return

    def _transfer(self, node):
        packet = op_packet(node)
        args = node.args
        shape = _shape(node)
        ins = [self._get(a) for a in args]
        first = ins[0] if ins else None
        in_shape = _shape(args[0]) if args and isinstance(args[0], fx.Node) \
            else None

        tag = node.meta.get("custom") or {}
        if packet.startswith("c10d."):
            return self._c10d(node, packet, tag)
        if packet in _DRAW or tag.get("mask_draw"):
            # a draw; on a device mesh tagged with its stream's role, and
            # the counter stream's one tagged node (its rows distinct)
            n = len(shape or ())
            if packet in ("aten.normal_", "aten.uniform_") and first:
                base = first
            else:
                base = Props(party=_zeros(n))
            var = tuple(s if s > 1 else 0 for s in shape or ())
            return Props(base.taint, False, base.party,
                         base.streams | {Stream(node.name, var, True,
                                                tag.get("mask_draw"),
                                                tag.get("stream"))})
        if packet in _CREATE:
            return Props(party=_zeros(len(shape or ())))
        if first is None and shape is not None:
            # no tensor operand in front (a scalar op, a list first)
            if packet in ("aten.cat", "aten.stack", "aten.concat"):
                return self._cat(node, packet)
            return self._elementwise(node, shape)
        if packet in ("aten.eq", "aten.ne", "aten.isnan", "aten.isinf",
                      "aten.isfinite", "aten.isposinf", "aten.isneginf") \
                and self._finiteness(node, packet):
            p = self._elementwise(node, shape)
            return Props(False, False, p.party, p.streams)
        if packet in _IDENTITY:
            if shape is None:
                return first
            return first if in_shape == shape else first.mapped(
                lambda a: _view(a, in_shape, shape))
        if packet in _RESHAPE:
            return first.mapped(lambda a: _view(a, in_shape, shape))
        if packet in _EXPAND:
            return first.mapped(lambda a: _bcast(a, in_shape, shape))
        if packet in ("aten.permute", "aten.transpose", "aten.t",
                      "aten.movedim", "aten.swapaxes", "aten.numpy_T"):
            return first.mapped(lambda a: self._permuted(node, packet, a))
        if packet == "aten.unsqueeze":
            d = args[1] % (len(in_shape) + 1)
            return first.mapped(lambda a: a[:d] + (0,) + a[d:])
        if packet == "aten.squeeze":
            return first.mapped(lambda a: _view(a, in_shape, shape))
        if packet == "aten.select":
            d = args[1] % len(in_shape)
            return first.mapped(lambda a: a[:d] + a[d + 1:])
        if packet in ("aten.slice", "aten.narrow", "aten.diagonal",
                      "aten.as_strided"):
            if len(shape) != len(in_shape):
                return first.mapped(lambda a: _zeros(len(shape)))
            return first.mapped(lambda a: _cap(a, shape))
        if packet in ("aten.split", "aten.split_with_sizes", "aten.chunk",
                      "aten.unbind", "aten.tensor_split"):
            vals = node.meta.get("val")
            outs = []
            for v in vals:
                s = tuple(v.shape)
                outs.append(first.mapped(
                    (lambda s: lambda a: _cap(a, s) if len(s) == len(a)
                     else _view(a, in_shape, s))(s)))
            return tuple(outs)
        if packet in ("aten.cat", "aten.stack", "aten.concat"):
            return self._cat(node, packet)
        if packet in _REDUCE:
            return self._reduce(node, packet, first, in_shape, shape)
        if packet in _SCAN:
            d = _norm_dims(args[1] if len(args) > 1
                           else node.kwargs.get("dim"), len(in_shape))
            if any(_crossing(first.party[k]) for k in d):
                return self._crossed(first, self._boundary(
                    node, "scan", first, in_shape, d, False))
            return first
        if packet in ("aten.roll", "aten.flip"):
            dims = args[2] if packet == "aten.roll" else args[1]
            dims = _norm_dims(dims if dims else None, len(in_shape))
            return self._permute_along(node, first, in_shape, dims, first)
        if packet == "aten.index_select":
            d = args[1] % len(in_shape)
            idx = ins[2] or Props(party=(0,))
            out = first.mapped(lambda a: _cap(a, shape))
            party = list(out.party)
            party[d] = max(party[d], idx.party[0] if idx.party else 0)
            out = _join(Props(out.taint, out.source, tuple(party),
                              out.streams),
                        Props(idx.taint, False, _zeros(len(shape)),
                              idx.mapped(lambda a: _bcast(
                                  a, _shape(args[2]), shape)).streams))
            return self._permute_along(node, first, in_shape, (d,), out)
        if packet == "aten.gather":
            d = args[1] % len(in_shape)
            idx = ins[2]
            out = first.mapped(lambda a: _cap(a, shape))
            if idx is not None:
                out = _join(out, Props(idx.taint, False, idx.party,
                                       idx.streams))
            return self._permute_along(node, first, in_shape, (d,), out)
        if packet == "aten.index":
            return self._index(node, first, in_shape, shape)
        if packet in _CONTRACT or packet in _ADD_CONTRACT:
            return self._contract(node, packet, ins, shape)
        if packet == "repro_torch.vfl_grad":
            return self._vfl_grad(node, ins)
        if packet in ("aten.index_copy", "aten.index_copy_", "aten.index_put",
                      "aten.index_put_", "aten.index_add", "aten.index_add_",
                      "aten.scatter", "aten.scatter_", "aten.scatter_add",
                      "aten.scatter_add_", "aten.copy_", "aten.copy",
                      "aten.masked_scatter", "aten.masked_scatter_"):
            return self._write(node, first, in_shape, ins)
        if shape is not None and self._broadcastable(node, shape):
            return self._elementwise(node, shape)
        self.unknown.add(packet)
        return self._union(node, shape)

    # -- rules ---------------------------------------------------------------

    def _finiteness(self, node, packet) -> bool:
        """``x == x``, ``x != x``, ``|x| == inf``, ``|x| != inf`` or a
        finiteness primitive: the verdict only."""
        if packet in ("aten.isnan", "aten.isinf", "aten.isfinite",
                      "aten.isposinf", "aten.isneginf"):
            return True
        a = node.args
        if len(a) > 1 and isinstance(a[1], fx.Node) and a[1] is a[0]:
            return True
        return (len(a) > 1 and isinstance(a[1], float) and math.isinf(a[1])
                and isinstance(a[0], fx.Node)
                and op_packet(a[0]) == "aten.abs")

    @staticmethod
    def _permuted(node, packet, a: Ann) -> Ann:
        n = len(a)
        if packet in ("aten.t", "aten.numpy_T"):
            return tuple(reversed(a))
        if packet in ("aten.transpose", "aten.swapaxes"):
            i, j = node.args[1] % n, node.args[2] % n
            out = list(a)
            out[i], out[j] = out[j], out[i]
            return tuple(out)
        if packet == "aten.movedim":
            src, dst = node.args[1], node.args[2]
            src = [src] if isinstance(src, int) else list(src)
            dst = [dst] if isinstance(dst, int) else list(dst)
            order = [d for d in range(n) if d not in [s % n for s in src]]
            for s, d in sorted(zip([x % n for x in dst],
                                   [x % n for x in src])):
                order.insert(s, d)
            return tuple(a[k] for k in order)
        perm = [p % n for p in node.args[1]]
        return tuple(a[p] for p in perm)

    def _broadcastable(self, node, shape) -> bool:
        for a in list(node.args) + list(node.kwargs.values()):
            s = _shape(a) if isinstance(a, fx.Node) else None
            if s is None:
                continue
            if len(s) > len(shape):
                return False
            for x, y in zip(reversed(s), reversed(shape)):
                if x != y and x != 1:
                    return False
        return True

    def _tensor_args(self, node):
        for a in list(node.args) + list(node.kwargs.values()):
            seq = a if isinstance(a, (list, tuple)) else [a]
            for x in seq:
                p = self._get(x)
                if p is not None:
                    yield x, p

    def _elementwise(self, node, shape) -> Props:
        out = Props(party=_zeros(len(shape)))
        for a, p in self._tensor_args(node):
            s = _shape(a) or ()
            q = p.mapped(lambda ann: _bcast(ann, s, shape))
            out = Props(out.taint or q.taint, False,
                        tuple(max(x, y) for x, y in zip(out.party, q.party)),
                        out.streams | q.streams)
        return out

    def _union(self, node, shape):
        """Unknown op: union of every tensor operand, party dimensions from
        an operand of the output's shape (none otherwise)."""
        n = len(shape) if shape is not None else 0
        out = Props(party=_zeros(n))
        for a, p in self._tensor_args(node):
            same = _shape(a) == shape
            out = Props(out.taint or p.taint, False,
                        p.party if same else out.party,
                        out.streams | frozenset(
                            s if same else dataclasses.replace(
                                s, var=_zeros(n)) for s in p.streams))
        if isinstance(node.meta.get("val"), (tuple, list)):
            return tuple(out for _ in node.meta["val"])
        return out

    def _permute_along(self, node, operand: Props, in_shape, dims,
                       out: Props) -> Props:
        if operand.source or operand.mask_only \
                or not any(_crossing(operand.party[d]) for d in dims):
            if operand.source:
                return Props(True, False, out.party, out.streams)
            return out
        return self._crossed(out, self._boundary(
            node, "collective-permute", operand, in_shape,
            [d for d in dims if _crossing(operand.party[d])], False))

    def _reduce(self, node, packet, first, in_shape, shape):
        args, kw = node.args, node.kwargs
        n = len(in_shape)
        if packet in ("aten.amax", "aten.amin", "aten.sum", "aten.mean",
                      "aten.logsumexp", "aten.nansum") and len(args) > 1:
            dims = _norm_dims(args[1] if args[1] is not None else None, n)
        elif packet == "aten.linalg_vector_norm":
            dims = _norm_dims(args[2] if len(args) > 2
                              else kw.get("dim"), n)
        elif len(args) > 1 and isinstance(args[1], (int, list, tuple)):
            dims = _norm_dims(args[1], n)
        else:
            dims = _norm_dims(kw.get("dim"), n)
        keep = len(shape or ()) == n if not isinstance(
            node.meta.get("val"), (tuple, list)) else \
            len(node.meta["val"][0].shape) == n
        out = first.mapped(lambda a: _drop(a, dims, keep))
        crosses = any(_crossing(first.party[d]) for d in dims) \
            or (first.mask_only and 0 in dims and in_shape and in_shape[0] > 1)
        if crosses:
            out = self._crossed(out, self._boundary(
                node, "all-reduce", first, in_shape, dims, True))
        if isinstance(node.meta.get("val"), (tuple, list)):
            return tuple(out for _ in node.meta["val"])
        return out

    def _cat(self, node, packet):
        tensors = node.args[0]
        shape = _shape(node)
        n = len(shape)
        d = (node.args[1] if len(node.args) > 1
             else node.kwargs.get("dim", 0)) % n
        out = Props(party=_zeros(n))
        for t in tensors:
            p = self._get(t)
            if p is None:
                continue
            if packet == "aten.stack":
                p = p.mapped(lambda a: a[:d] + (0,) + a[d:])
            else:
                s = _shape(t)
                p = p.mapped(lambda a: tuple(
                    shape[k] if (k == d and a[k] > 0) else a[k]
                    for k in range(n))) if s and len(s) == n else p
            out = Props(out.taint or p.taint, False,
                        tuple(max(x, y) for x, y in zip(out.party, p.party)),
                        out.streams | p.streams)
        if packet == "aten.stack":
            out = self._stacked_draws(node, tensors, d, out)
        return out

    def _stacked_draws(self, node, tensors, d: int, out: Props) -> Props:
        """A stack of k draws, each from another party's own stream (a
        device mesh rank's parties, ``secure_agg._draws``), is distinct
        along the stacked dimension: one stream of k rows.  The rows' tags
        must name k different parties; two draws of one party's stream
        are not distinct along the stack."""
        own = []
        for t in tensors:
            p = self._get(t)
            s = [x for x in (p.streams if p else ()) if x.role == "own"]
            if not s or not p.mask_only:
                return out
            own.append(s[0])
        parties = [s.index for s in own]
        if len(own) < 2 or None in parties \
                or len(set(parties)) < len(parties):
            return out
        var = list(own[0].var[:d] + (0,) + own[0].var[d:])
        var[d] = len(own)
        return Props(out.taint, out.source, out.party, out.streams | {
            Stream(node.name, tuple(var), True, "own")})

    def _index(self, node, first, in_shape, shape):
        indices = node.args[1]
        pos = [k for k, t in enumerate(indices) if t is not None]
        n_out = len(shape)
        if not pos:
            return first
        lo, hi = pos[0], pos[-1]
        idx_props = [self._get(indices[k]) for k in pos]
        bshape = shape[lo:n_out - (len(in_shape) - hi - 1)]
        contiguous = pos == list(range(lo, hi + 1)) and \
            len(shape) == lo + len(bshape) + len(in_shape) - hi - 1
        if not contiguous:
            out = Props(first.taint, False, _zeros(n_out),
                        frozenset(dataclasses.replace(s, var=_zeros(n_out))
                                  for s in first.streams))
        else:
            def remap(a: Ann) -> Ann:
                lead = max((min(a[k], bshape[0]) for k in pos), default=0) \
                    if bshape else 0
                mid = [0] * len(bshape)
                if mid:
                    mid[0] = lead
                return a[:lo] + tuple(mid) + a[hi + 1:]
            out = first.mapped(remap)
            for t, p in zip((indices[k] for k in pos), idx_props):
                if p is None:
                    continue
                q = p.mapped(lambda a: (0,) * lo + _bcast(
                    a, _shape(t), bshape) + (0,) * (n_out - lo - len(bshape)))
                out = _join(out, Props(q.taint, False, q.party, q.streams))
        return self._permute_along(node, first, in_shape, tuple(pos), out)

    def _write(self, node, first, in_shape, ins):
        """A functional or in-place write (``index_copy_``, ``index_put_``,
        ``copy_``, ...): the written tensor's state joined with what is
        written into it."""
        out = first
        for a, p in list(self._tensor_args(node))[1:]:
            s = _shape(a) or ()
            if len(s) == len(in_shape):
                q = p.mapped(lambda ann: tuple(
                    0 if (x == 1 and y != 1) else min(v, y)
                    for v, x, y in zip(ann, s, in_shape)))
            else:
                q = p.mapped(lambda ann: _bcast(ann, s, in_shape)
                             if len(s) < len(in_shape)
                             else _zeros(len(in_shape)))
            out = Props(out.taint or q.taint, out.source and q.source,
                        out.party, out.streams | q.streams)
        return out

    def _contract(self, node, packet, ins, shape):
        if packet in _ADD_CONTRACT:
            base = ins[0]
            spec = _CONTRACT[_ADD_CONTRACT[packet]]
            res = self._einsum(node, list(node.args[1:3]), ins[1:3], spec,
                               shape)
            if base is None:
                return res
            b = base.mapped(lambda a: _bcast(a, _shape(node.args[0]), shape))
            return _join(res, b)
        return self._einsum(node, list(node.args[:2]), ins[:2],
                            _CONTRACT[packet], shape)

    def _einsum(self, node, args, ins, spec, shape):
        """A contraction ``spec`` = (subscripts of each input ..., output):
        an output letter takes the inputs' counts along it; a contracted
        letter that is a party dimension of an input is a reduction
        boundary."""
        *subs, out_sub = spec
        sizes = dict(zip(out_sub, shape))
        out = Props(party=_zeros(len(out_sub)))
        crossing = None
        for a, p, sub in zip(args, ins, subs):
            if p is None or sub is None:
                continue
            s = _shape(a)

            def remap(ann, sub=sub, s=s):
                res = []
                for ch in out_sub:
                    if ch not in sub:
                        res.append(0)
                        continue
                    k = sub.index(ch)
                    res.append(0 if (s[k] == 1 and sizes[ch] != 1)
                               else min(ann[k], sizes[ch]))
                return tuple(res)

            contracted = [k for k, ch in enumerate(sub) if ch not in out_sub]
            if any(_crossing(p.party[k]) for k in contracted) \
                    and crossing is None:
                crossing = (p, s, [k for k in contracted
                                   if _crossing(p.party[k])])
            q = p.mapped(remap)
            out = Props(out.taint or p.taint, False,
                        tuple(max(x, y) for x, y in zip(out.party, q.party)),
                        out.streams | q.streams)
        if crossing is not None:
            p, s, dims = crossing
            out = self._crossed(out, self._boundary(node, "all-reduce", p, s,
                                                    dims, True))
        return out

    def _c10d(self, node, packet, tag):
        """A collective over a device mesh's process group (the c10d node
        ``make_fx`` records); its group's role comes from the call site's
        tag (``secure_agg.trace_tag``), the model group where there is
        none.  Over the model group an ``allreduce_`` is an all-reduce
        boundary on its operand, a ``send`` a collective-permute boundary
        on the sent operand, a ``broadcast_`` a collective-broadcast
        boundary (the root's operand leaves it), each a collective: its
        operand must carry a stream that differs from rank to rank
        (``RANK_DISTINCT``).  A model-group ``broadcast_`` tagged
        ``release=SERVED_ANSWER`` is the served answer, released: counted,
        and its value public.  A ``broadcast_`` writes its result into its
        buffer, so later reads of the buffer come from the collective; a
        ``recv_`` writes another party's message, checked at its sender's
        ``send``, into its buffer and adds nothing to it.  Over the data
        group (the data shards of the same
        parties) a collective is a plain sum.  Any other c10d op fails
        closed: a boundary on every operand, and recorded as unknown."""
        role = tag.get("collective", "model")
        if packet not in _C10D:
            return self._c10d_unknown(node, packet)
        tensors = node.args[0] if node.args \
            and isinstance(node.args[0], (list, tuple)) else ()
        ins = [(t, self._get(t)) for t in tensors if isinstance(t, fx.Node)]
        if packet == "c10d.recv_":
            return None
        outs = []
        for t, p in ins:
            if p is None:
                outs.append(None)
                continue
            shape = _shape(t) or ()
            if packet == "c10d.broadcast_" and role == "model" \
                    and tag.get("release") == SERVED_ANSWER:
                if self._emit:
                    self.released += 1
                out = Props(party=_zeros(len(shape)))
            elif role == "data":
                out = p
            else:
                kind = {"c10d.allreduce_": "all-reduce",
                        "c10d.send": "collective-permute",
                        "c10d.broadcast_": "collective-broadcast"}[packet]
                out = self._crossed(p, self._boundary(
                    node, kind, p, shape, (), kind == "all-reduce", t, True))
            if packet == "c10d.broadcast_":
                self._write_root(t, out)
            outs.append(out)
        return None if packet == "c10d.send" else (tuple(outs), None)

    def _c10d_unknown(self, node, packet):
        """A c10d op with no rule, over either group: recorded as unknown,
        a boundary on each tensor operand (whichever argument holds it),
        and every operand's state in every tensor it writes or returns."""
        self.unknown.add(packet)
        flat = []
        for a in node.args:
            flat.extend(a if isinstance(a, (list, tuple)) else (a,))
        ins = [(t, p) for t in flat for p in (self._get(t),) if p is not None]
        taint, streams = False, frozenset()
        for t, p in ins:
            crossed = self._crossed(p, self._boundary(
                node, packet, p, _shape(t) or (), (), False, t, True))
            taint, streams = taint or crossed.taint, streams | crossed.streams
        for t, _ in ins:
            self._write_root(t, Props(taint, False, (), streams))

        def like(val):
            if isinstance(val, (list, tuple)):
                return tuple(like(v) for v in val)
            if not isinstance(val, torch.Tensor):
                return None
            return Props(taint, False, _zeros(val.dim()), frozenset(
                dataclasses.replace(s, var=_zeros(val.dim()))
                for s in streams))
        return like(node.meta.get("val"))

    def _write_root(self, target, props: Props) -> None:
        """Join ``props`` into what later reads of ``target``'s root see."""
        root = self.root.get(target.name, target.name)
        n = len(self._shapes.get(root) or ())
        prev = self._writes.get(root, Props())
        self._writes[root] = Props(
            prev.taint or props.taint, False, (), prev.streams | frozenset(
                dataclasses.replace(s, var=_zeros(n)) for s in props.streams))

    def _vfl_grad(self, node, ins):
        """``repro_torch.vfl_grad``: forward z = x·w, backward g = xᵀθ, fused
        both (a tuple), as contractions over its operands' letters."""
        overload = node.target._overloadname
        x = node.args[0]
        lead = "p" if len(_shape(x)) == 3 else ""
        xs = lead + "bd"
        vals = node.meta.get("val")

        def fwd(w, pw, z_shape):
            ws = lead + ("d" if len(_shape(w)) == len(xs) - 1 else "dm")
            zs = lead + "b" + ("m" if ws.endswith("m") else "")
            return self._einsum(node, [x, w], [ins[0], pw], (xs, ws, zs),
                                z_shape)

        def bwd(th, pth, g_shape):
            ts = lead + ("b" if len(_shape(th)) == len(xs) - 1 else "bm")
            gs = lead + "d" + ("m" if ts.endswith("m") else "")
            return self._einsum(node, [x, th], [ins[0], pth], (xs, ts, gs),
                                g_shape)

        if overload == "forward":
            return fwd(node.args[1], ins[1], tuple(vals.shape))
        if overload == "backward":
            g = bwd(node.args[1], ins[1], tuple(vals.shape))
            w = ins[2] if len(ins) > 2 else None
            return g if w is None else _join(g, w.mapped(
                lambda a: _bcast(a, _shape(node.args[2]), tuple(vals.shape))))
        return (fwd(node.args[1], ins[1], tuple(vals[0].shape)),
                bwd(node.args[2], ins[2], tuple(vals[1].shape)))


def seed_findings(tables) -> List[TaintFinding]:
    """The seed check of a device mesh's mask streams, whose seeds are
    runtime values no trace holds.  ``tables`` has one entry a rank,
    ``(data index, PartyStreams.seeds())`` after the same ``seed(*key)``
    on every rank.  Own-party seeds must be pairwise distinct over the q
    parties, slot seeds over the slots, and each rank's ``prev`` seed the
    own (flat) or slot (packed) seed of the party or slot before it on
    the same data shard; each violation is a ``mask-not-party-distinct``
    finding (equal seeds draw equal masks, which cancel in the
    aggregator's view; a ``prev`` that is not its neighbour's leaves the
    ring's masks uncancelled)."""
    findings: List[TaintFinding] = []

    def find(detail):
        f = TaintFinding(EQUAL_SEEDED, "seed", "streams", detail)
        if f not in findings:
            findings.append(f)

    own = {}
    for d, rows in tables:
        for role, level, index, seed in rows:
            if role in ("own", "slot"):
                own[(d, level, index)] = seed
    for level in ("party", "slot"):
        by_seed: Dict[int, set] = {}
        for (_, lv, i), seed in own.items():
            if lv == level:
                by_seed.setdefault(seed, set()).add(i)
        for seed, ids in sorted(by_seed.items()):
            if len(ids) > 1:
                find(f"the {level} streams {sorted(ids)} share the seed "
                     f"{seed}")
    for d, rows in tables:
        for role, level, index, seed in rows:
            if role == "prev" and own.get((d, level, index)) != seed:
                find(f"a ring's prev stream is not seeded as {level} "
                     f"{index}'s own stream")
    return findings


def analyze_program(program, membership: bool = False,
                    sources: Sequence[str] = ()) -> List[TaintFinding]:
    """Run the leakage taint pass over a traced program.  The source is the
    feature block the program's ``gm.meta["consts"]`` names (an engine
    trace), or the placeholders named in ``sources`` (a mutant's
    partial).  ``membership=True`` adds the membership rule.  Returns the
    findings; empty means every boundary crossing is masked per party."""
    return Analyzer(program, membership, sources).run().findings


def boundaries(program, sources: Sequence[str] = ()) -> List[Boundary]:
    """Every party-axis crossing of a traced program, in node order."""
    return Analyzer(program, False, sources).run().boundaries


def finding_codes(findings: Sequence[TaintFinding]) -> Dict[str, int]:
    """Histogram of finding codes (the manifest-stable summary)."""
    out: Dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return dict(sorted(out.items()))
