"""Public wrappers for the port's kernels.

``vfl_grad``, ``selective_scan``, ``flash_attention`` and
``decode_attention`` keep the signatures of their counterparts in
``repro.kernels.ops`` (without Pallas's tiling and interpret arguments).
The tensors they are given decide where they run: on CUDA tensors they
launch the hand-written CUDA kernel (``kernels.vfl_grad``,
``kernels.selective_scan``, ``kernels.flash_attention``,
``kernels.decode_attention``) or raise; on CPU tensors they run the plain
version (``kernels.ref``).  Nothing falls back from one to the other.

``vfl_grad``'s launch is the operator ``repro_torch::vfl_grad`` (overloads
``forward``, ``backward`` and ``fused``, registered with
``torch.library.Library``): the plain version for CPU tensors, the CUDA
programs for CUDA tensors, and a shape-only one for meta and fake
tensors.  Inside a ``make_fx`` trace the wrapper calls the operator, so a
trace holds one ``repro_torch.vfl_grad`` node where the card makes one
launch of a minibatch step, on either device (``repro_torch.analysis``
counts them); an eager call runs the same implementation directly, as
the dispatcher's call back into Python costs 6–12 host µs a launch on
the card (``PERF.md``).

``selective_scan``, ``flash_attention`` and ``decode_attention`` are
forward-only, as the reference's Pallas kernels are (they define no
gradient): under autograd (``torch.is_grad_enabled()``) with a tensor
input that requires grad each raises ``RuntimeError``, on either device,
so that a kernel output never silently drops its gradient.  Training
takes the plain routes (``Runtime(scan_impl="reference",
attn_impl="reference")``); under ``torch.no_grad()``, or with inputs that
need no grad, the wrappers run as described above.

Inside ``fake_kernels()`` (the dry run of ``launch.dryrun``), fake
tensors (``torch._subclasses.fake_tensor.FakeTensor``) outside a
``make_fx`` trace take a third route, the CUDA route's shape-only twin:
each wrapper makes the copies the CUDA route makes, then ``_FakeKernels``
returns the kernel's outputs as empty tensors of its shapes, dtypes and
stride order and takes the workspaces the CUDA kernel takes from
PyTorch's allocator (decode's chunk partials, the backward's per-chunk
partials), and runs neither version.  Each fake launch adds one to the
context's ``FakeTally`` count of its program, where the card's counter
would add one, and its analytic FLOPs and bytes (the counts the kernel
rows' bounds use) to the tally, since ``torch.utils.flop_counter`` sees
nothing inside an empty.  Everywhere else a fake tensor goes by its
device as a real one does, so a fake trace (``make_fx(tracing_mode=
"fake")``, ``torch.export``) records the plain version on the CPU.
Real tensors go where they went: a CPU tensor runs the plain version, a
CUDA tensor the kernel, any other device raises.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import vfl_grad as _vg

_DTYPES = (torch.float32, torch.bfloat16)
# the tally of the open ``fake_kernels()`` context, None outside one
_TALLY = None


def _fake_route(t) -> bool:
    """Whether ``t`` takes the fake route: a fake tensor inside
    ``fake_kernels()``, and no ``make_fx`` trace recording."""
    return _TALLY is not None and isinstance(t, FakeTensor) \
        and get_proxy_mode() is None


def _nbytes(*tensors) -> int:
    """Bytes the tensors cover: an ``expand`` view (a shared θ) once."""
    return sum(t.untyped_storage().nbytes() if t.dim() and t.stride(0) == 0
               else t.numel() * t.element_size() for t in tensors
               if t is not None)


class FakeTally:
    """What the fake route's launches would have done on the card, by
    program: ``launches``, ``flops`` (analytic) and ``bytes`` (each input
    read once, each output written once)."""

    def __init__(self):
        self.launches, self.flops, self.bytes = Counter(), Counter(), Counter()

    def add(self, prog: str, flops: float, nbytes: int) -> None:
        self.launches[prog] += 1
        self.flops[prog] += float(flops)
        self.bytes[prog] += int(nbytes)


@contextlib.contextmanager
def fake_kernels():
    """Route fake tensors to the kernels' shape-only twins while open;
    yields the ``FakeTally`` of the launches they make."""
    global _TALLY
    outer, _TALLY = _TALLY, FakeTally()
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def _valid_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps: query t sees keys <= t
    (``causal``) and > t - ``window``."""
    t = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, t + 1) if causal else np.full(sq, skv)
    lo = np.zeros(sq, np.int64) if window is None \
        else np.maximum(0, t - int(window) + 1)
    return int(np.maximum(0, hi - lo).sum())


class _FakeKernels:
    """The CUDA kernel objects' shape-only twins (``kernels.vfl_grad``,
    ``selective_scan``, ``flash_attention``, ``decode_attention``): the
    same outputs and workspaces, allocated and left empty, and each
    launch tallied in the open ``fake_kernels()`` tally."""

    @staticmethod
    def forward(x, w):
        p, b, d = x.shape
        m = w.shape[2]
        z = torch.empty((p, b, m), dtype=torch.float32, device=x.device)
        if z.numel():
            _TALLY.add(_vg.PROGRAMS[0] if m <= _vg.NARROW_MAX_M
                       else _vg.PROGRAMS[1], 2.0 * p * b * d * m,
                       _nbytes(x, w, z))
        return z

    @staticmethod
    def _reduce(ws, w, g):
        chunks, p, d, m = ws.shape
        _TALLY.add("vfl_backward_reduce", float(chunks * p * d * m),
                   _nbytes(ws, w, g))

    def backward(self, x, theta, w, lam, denom):
        p, b, d = x.shape
        m = theta.shape[2]
        g = torch.empty((p, d, m), dtype=torch.float32, device=x.device)
        if g.numel() == 0:
            return g
        chunks = -(-b // _vg.BWD_CHUNK_ROWS)
        out = g if chunks == 1 else torch.empty(
            (chunks, p, d, m), dtype=torch.float32, device=x.device)
        _TALLY.add("vfl_backward_rows", 2.0 * p * b * d * m,
                   _nbytes(x, theta, w, out))
        if chunks > 1:
            self._reduce(out, w, g)
        return g

    def fused(self, x, w, theta, lam, denom, split):
        p, b, d = x.shape
        mw, nb, mth = w.shape[2], theta.shape[1], theta.shape[2]
        f0 = 0 if split is None else split
        z = torch.empty((p, b - f0, mw), dtype=torch.float32,
                        device=x.device)
        g = torch.empty((p, d, mth), dtype=torch.float32, device=x.device)
        chunks = -(-nb // _vg.BWD_CHUNK_ROWS)
        out = g if chunks == 1 else torch.empty(
            (chunks, p, d, mth), dtype=torch.float32, device=x.device)
        _TALLY.add("vfl_fused_split",
                   2.0 * p * (b - f0) * d * mw + 2.0 * p * nb * d * mth,
                   _nbytes(x, w, theta, z, out))
        if chunks > 1:
            self._reduce(out, w if lam != 0.0 else None, g)
        return z, g

    @staticmethod
    def scan(xa, dt, b_ssm, c_ssm, a_log, d_skip):
        y = torch.empty_like(xa)
        if y.numel():
            bsz, s, c = xa.shape
            n = a_log.shape[-1]
            _TALLY.add("selective_scan",
                       5.0 * bsz * s * c * n + 3.0 * bsz * s * c,
                       _nbytes(xa, dt, b_ssm, c_ssm, a_log, d_skip, y))
        return y

    @staticmethod
    def attend(q, k, v, causal, window):
        o = torch.empty_like(q)
        if o.numel():
            b, h, sq, dh = q.shape
            pairs = _valid_pairs(sq, k.shape[2], causal, window)
            _TALLY.add("flash_attention", 4.0 * b * h * dh * pairs,
                       _nbytes(q, k, v, o))
        return o

    @staticmethod
    def partials(q, k_cache, v_cache, pos, shards, offset, window,
                 value):
        b, h, dh = q.shape
        s, hkv = k_cache.shape[1], k_cache.shape[2]
        o = torch.empty((shards, b, h, dh), dtype=torch.float32,
                        device=q.device)
        m = torch.empty((shards, b, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        if o.numel() == 0:
            return o, m, l
        chunks, _ = _da.chunk_plan(s // shards)
        torch.empty((shards, chunks, b, h, dh + 2), dtype=torch.float32,
                    device=q.device)                 # the chunk partials
        lo = max(offset, 0 if window is None else value - int(window) + 1)
        valid = max(0, min(offset + s, value + 1) - lo)
        kv_bytes = 2 * b * valid * hkv * dh * k_cache.element_size()
        _TALLY.add("decode_attention", 4.0 * b * h * dh * valid,
                   _nbytes(q, o, m, l) + kv_bytes)
        return o, m, l


FAKE_KERNELS = _FakeKernels()


def _contig(t: torch.Tensor) -> torch.Tensor:
    # a no-op call still costs a dispatch, and releases the interpreter
    # lock: threads that launch (core/async_engine.py) hand it over there
    return t if t.is_contiguous() else t.contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _forward_only(name: str, route: str, *inputs):
    """Raise where autograd would need a gradient of kernel ``name``:
    grad mode is on and an input requires grad (the module's rule)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} is forward-only (its kernel defines no gradient, as the "
            f"reference's does not) and an input requires grad: take the "
            f"plain route ({route}=\"reference\") to differentiate, or call "
            "it under torch.no_grad()")


def vfl_grad(xb, w, theta=None, lam=0.0, *, mode="forward", denom=None,
             split=None):
    """Batched rank-k VFL kernel: forward, backward or fused mode.

    ``mode="forward"``: ``(z, None)`` with z = xb @ w accumulated in f32.
    ``theta``, ``lam`` and ``denom`` are accepted and unused, as in the
    reference.

    ``mode="backward"``: ``(None, g)`` with g = xbᵀθ/denom + λw, the BUM
    gradient; ``denom`` defaults to the number of rows B.  ``w=None`` is
    allowed with ``lam=0`` (the pure XᵀΘ the engine's steps use); a
    nonzero ``lam`` needs ``w`` with θ's column count.  θ may be bfloat16
    or float32 and is read as float32, as the reference's kernel reads it.

    Shapes: xb (B, D) with w (D,) or (D, M) and θ (B,) or (B, M); or,
    with a leading party axis so that one launch serves all parties, xb
    (P, B, D) with w (P, D) or (P, D, M) and θ (P, B) or (P, B, M).  A
    θ shared by every party is passed as an ``expand`` view of one (B,)
    or (B, M) θ: the kernel reads it with a party stride of 0, and nothing
    is copied.  Rank-1 w or θ gives a rank-1 result per party, as in the
    reference.  xb and w share a dtype, float32 or bfloat16; z and g are
    float32.

    ``mode="fused"``: ``(z, g)`` from one launch.  Without ``split`` both
    come from the same B rows, θ has B rows and w and θ one column count.
    With ``split`` (0 < split < B; the pipelined step) rows [0, split) are
    the backward block, against θ of ``split`` rows, and rows [split, B)
    the forward block, whose z is returned; the two sides' column counts
    Mw and Mθ may differ (Mw = 1 beside a block-diagonal Θ of Mθ = m).
    ``denom`` defaults to the backward rows; a nonzero ``lam`` needs w
    and θ with one column count.  Each side squeezes to rank 1 with its
    own operand.  ``split`` outside the fused mode is an error.
    """
    if mode not in ("forward", "backward", "fused"):
        raise ValueError(f"unknown mode {mode!r}")
    if split is not None and mode != "fused":
        raise ValueError("split= is the fused mode's split-batch form; "
                         f"got mode={mode!r}")
    if xb.dtype not in _DTYPES:
        raise ValueError(f"xb must be one of {_DTYPES}; got {xb.dtype}")
    if xb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vfl_grad runs on cpu or cuda, not {xb.device}")
    if mode == "forward":
        return _forward(xb, w), None
    if mode == "fused":
        return _fused(xb, w, theta, lam, denom, split)
    return None, _backward(xb, w, theta, lam, denom)


def _forward(xb, w):
    if w is None:
        raise ValueError("mode='forward' needs w")
    if w.dtype != xb.dtype:
        raise ValueError(f"xb and w must share a dtype in {_DTYPES}; got "
                         f"{xb.dtype}, {w.dtype}")
    if w.device != xb.device:
        raise ValueError(f"xb on {xb.device}, w on {w.device}")
    if not ((xb.dim() == 2 and w.dim() in (1, 2))
            or (xb.dim() == 3 and w.dim() in (2, 3)
                and w.shape[0] == xb.shape[0])):
        raise ValueError(f"bad shapes xb {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}: want (B, D) with (D,)/(D, M) "
                         "or (P, B, D) with (P, D)/(P, D, M)")
    if w.shape[xb.dim() - 2] != xb.shape[-1]:
        raise ValueError(f"contraction mismatch: xb {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}")
    return _launch("forward", xb, w)


def _cuda_forward(xb, w, kern=None):
    rank1 = w.dim() == xb.dim() - 1
    if xb.dim() == 2:
        x3 = xb.unsqueeze(0)
        w3 = w.reshape(1, w.shape[0], 1 if rank1 else w.shape[1])
    else:
        x3 = xb
        w3 = w.unsqueeze(-1) if rank1 else w
    z = (kern or _vg.KERNEL).forward(x3, w3)
    if rank1:
        z = z.squeeze(-1)
    return z.squeeze(0) if xb.dim() == 2 else z


def _backward(xb, w, theta, lam, denom):
    if theta is None:
        raise ValueError("mode='backward' needs theta")
    lam = float(lam)
    if w is None and lam != 0.0:
        raise ValueError("the λw term needs w; pass lam=0 with w=None")
    if not theta.is_floating_point():
        raise ValueError(f"theta must be floating point; got {theta.dtype}")
    for t, name in ((theta, "theta"), (w, "w")):
        if t is not None and t.device != xb.device:
            raise ValueError(f"xb on {xb.device}, {name} on {t.device}")
    if w is not None and w.dtype != xb.dtype:
        raise ValueError(f"xb and w must share a dtype in {_DTYPES}; got "
                         f"{xb.dtype}, {w.dtype}")
    lead = xb.dim() - 2                     # 0, or 1 with the party axis
    if (xb.dim() not in (2, 3) or theta.dim() not in (xb.dim() - 1, xb.dim())
            or theta.shape[:lead + 1] != xb.shape[:lead + 1]
            or (w is not None
                and (w.dim() != theta.dim()
                     or w.shape[:lead] != xb.shape[:lead]
                     or w.shape[lead] != xb.shape[-1]
                     or w.shape[lead + 1:] != theta.shape[lead + 1:]))):
        raise ValueError(
            f"bad shapes xb {tuple(xb.shape)}, theta {tuple(theta.shape)}, "
            f"w {None if w is None else tuple(w.shape)}: want (B, D) with "
            "θ (B,)/(B, M) and w None/(D,)/(D, M), or (P, B, D) with θ "
            "(P, B)/(P, B, M) and w None/(P, D)/(P, D, M)")
    denom = xb.shape[-2] if denom is None else int(denom)
    return _launch("backward", xb, theta, w, lam, denom)


def _cuda_backward(xb, theta, w, lam, denom, kern=None):
    lead = xb.dim() - 2
    rank1 = theta.dim() == xb.dim() - 1
    th3 = theta.unsqueeze(-1) if rank1 else theta
    th3 = th3.unsqueeze(0) if lead == 0 else th3
    x3 = xb.unsqueeze(0) if lead == 0 else xb
    w3 = None
    if w is not None:
        w3 = w.unsqueeze(-1) if rank1 else w
        w3 = _contig(w3.unsqueeze(0) if lead == 0 else w3)
    th3 = _f32(th3)
    if not (th3.stride(0) == 0 and th3[0].is_contiguous()):
        th3 = _contig(th3)                  # not a shared (expanded) θ
    g = (kern or _vg.KERNEL).backward(_contig(x3), th3, w3, lam,
                                      float(denom))
    if rank1:
        g = g.squeeze(-1)
    return g.squeeze(0) if lead == 0 else g


def _fused(xb, w, theta, lam, denom, split):
    if w is None or theta is None:
        raise ValueError("mode='fused' needs w and theta")
    lam = float(lam)
    if w.dtype != xb.dtype:
        raise ValueError(f"xb and w must share a dtype in {_DTYPES}; got "
                         f"{xb.dtype}, {w.dtype}")
    if not theta.is_floating_point():
        raise ValueError(f"theta must be floating point; got {theta.dtype}")
    for t, name in ((theta, "theta"), (w, "w")):
        if t.device != xb.device:
            raise ValueError(f"xb on {xb.device}, {name} on {t.device}")
    lead = xb.dim() - 2                     # 0, or 1 with the party axis
    b, d = xb.shape[-2], xb.shape[-1]
    if split is not None and not 0 < int(split) < b:
        raise ValueError(f"split must lie in (0, {b}); got {split}")
    nb = b if split is None else int(split)
    w_rank1 = w.dim() == xb.dim() - 1
    th_rank1 = theta.dim() == xb.dim() - 1
    if (xb.dim() not in (2, 3) or w.dim() not in (lead + 1, lead + 2)
            or theta.dim() not in (lead + 1, lead + 2)
            or w.shape[:lead] != xb.shape[:lead] or w.shape[lead] != d
            or theta.shape[:lead] != xb.shape[:lead]
            or theta.shape[lead] != nb):
        raise ValueError(
            f"bad shapes xb {tuple(xb.shape)}, w {tuple(w.shape)}, theta "
            f"{tuple(theta.shape)}, split {split}: want (B, D) with w "
            "(D,)/(D, Mw) and θ (Bb,)/(Bb, Mθ), or (P, B, D) with w "
            "(P, D)/(P, D, Mw) and θ (P, Bb)/(P, Bb, Mθ); Bb = split or B")
    mw = 1 if w_rank1 else w.shape[-1]
    mth = 1 if th_rank1 else theta.shape[-1]
    if split is None and mw != mth:
        raise ValueError(f"the fused mode without split needs one column "
                         f"count; got Mw={mw}, Mθ={mth}")
    if lam != 0.0 and mw != mth:
        raise ValueError(f"nonzero lam needs w with θ's column count "
                         f"(Mw={mw}, Mθ={mth}); pass lam=0 and add the "
                         "regularizer outside the kernel")
    denom = nb if denom is None else int(denom)
    return _launch("fused", xb, w, theta, lam, denom,
                   None if split is None else int(split))


def _cuda_fused(xb, w, theta, lam, denom, split, kern=None):
    lead = xb.dim() - 2
    d = xb.shape[-1]
    w_rank1 = w.dim() == xb.dim() - 1
    th_rank1 = theta.dim() == xb.dim() - 1
    mw = 1 if w_rank1 else w.shape[-1]
    x3 = xb.unsqueeze(0) if lead == 0 else xb
    w3 = w.reshape(x3.shape[0], d, mw)
    th3 = theta.unsqueeze(-1) if th_rank1 else theta
    th3 = _f32(th3.unsqueeze(0) if lead == 0 else th3)
    if not (th3.stride(0) == 0 and th3[0].is_contiguous()):
        th3 = _contig(th3)                  # not a shared (expanded) θ
    z, g = (kern or _vg.KERNEL).fused(_contig(x3), _contig(w3), th3, lam,
                                      float(denom), split)
    if w_rank1:
        z = z.squeeze(-1)
    if th_rank1:
        g = g.squeeze(-1)
    return (z.squeeze(0), g.squeeze(0)) if lead == 0 else (z, g)


# ---------------------------------------------------------------------------
# the operator repro_torch::vfl_grad: one trace node per launch
# ---------------------------------------------------------------------------

def _meta_forward(xb, w):
    rank1 = w.dim() == xb.dim() - 1
    return xb.new_empty(xb.shape[:-1] + (() if rank1 else w.shape[-1:]),
                        dtype=torch.float32)


def _meta_backward(xb, theta, w, lam, denom):
    rank1 = theta.dim() == xb.dim() - 1
    return xb.new_empty(xb.shape[:-2] + xb.shape[-1:]
                        + (() if rank1 else theta.shape[-1:]),
                        dtype=torch.float32)


def _meta_fused(xb, w, theta, lam, denom, split):
    fwd = xb if split is None else xb[..., split:, :]
    bwd = xb if split is None else xb[..., :split, :]
    return _meta_forward(fwd, w), _meta_backward(bwd, theta, w, lam, denom)


# each mode's implementations: CPU tensors, CUDA tensors, meta / fake ones
_IMPLS = {"forward": (ref.vfl_forward_ref, _cuda_forward, _meta_forward),
          "backward": (ref.vfl_backward_ref, _cuda_backward, _meta_backward),
          "fused": (ref.vfl_fused_ref, _cuda_fused, _meta_fused)}
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("vfl_grad.forward(Tensor xb, Tensor w) -> Tensor")
_LIB.define("vfl_grad.backward(Tensor xb, Tensor theta, Tensor? w, "
            "float lam, int denom) -> Tensor")
_LIB.define("vfl_grad.fused(Tensor xb, Tensor w, Tensor theta, float lam, "
            "int denom, int? split) -> (Tensor, Tensor)")
for _mode, _fns in _IMPLS.items():
    for _key, _fn in zip(("CPU", "CUDA", "Meta"), _fns):
        _LIB.impl(f"vfl_grad.{_mode}", _fn, _key)


def _launch(mode: str, xb, *args):
    """One ``vfl_grad`` launch of ``mode``: the operator inside a ``make_fx``
    trace (one node), else its implementation for ``xb``'s device (the
    CUDA route with ``FAKE_KERNELS`` on the fake route)."""
    if get_proxy_mode() is not None:
        return getattr(torch.ops.repro_torch.vfl_grad, mode)(xb, *args)
    if _fake_route(xb):
        return _IMPLS[mode][1](xb, *args, kern=FAKE_KERNELS)
    return _IMPLS[mode][1 if xb.is_cuda else 0](xb, *args)


def selective_scan(xa, dt, b_ssm, c_ssm, a_log, d_skip):
    """The mamba-1 selective scan from a zero state; returns y only.

    xa (B, S, C) f32 or bf16; dt (B, S, C), b_ssm and c_ssm (B, S, N),
    a_log (C, N) and d_skip (C,), each read as f32; y (B, S, C) in xa's
    dtype.  On the card N must be one of ``selective_scan.STATE_SIZES``;
    any B, S and C are taken."""
    if xa.dtype not in _DTYPES:
        raise ValueError(f"xa must be one of {_DTYPES}; got {xa.dtype}")
    if xa.dim() != 3 or a_log.dim() != 2:
        raise ValueError(f"want xa (B, S, C) and a_log (C, N); got xa "
                         f"{tuple(xa.shape)}, a_log {tuple(a_log.shape)}")
    _forward_only("selective_scan", "scan_impl", xa, dt, b_ssm, c_ssm, a_log,
                  d_skip)
    bsz, s, c = xa.shape
    n = a_log.shape[1]
    for t, name, shape in ((dt, "dt", (bsz, s, c)),
                           (b_ssm, "b_ssm", (bsz, s, n)),
                           (c_ssm, "c_ssm", (bsz, s, n)),
                           (a_log, "a_log", (c, n)), (d_skip, "d_skip", (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if t.device != xa.device:
            raise ValueError(f"xa on {xa.device}, {name} on {t.device}")
    kind = _device_kind(xa, "selective_scan")
    if kind == "cpu":
        return ref.selective_scan(xa, dt, b_ssm, c_ssm, a_log, d_skip)
    return _kernel(kind, _ss).scan(xa.contiguous(), *(
        t.float().contiguous() for t in (dt, b_ssm, c_ssm, a_log, d_skip)))


def _device_kind(t: torch.Tensor, name: str) -> str:
    """"fake" on the fake route, else "cpu" or "cuda"; any other device
    raises."""
    if _fake_route(t):
        return "fake"
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return t.device.type


def _kernel(kind: str, module):
    """The kernel object of ``module`` on the card, its twin for fakes."""
    return FAKE_KERNELS if kind == "fake" else module.KERNEL


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels' vector loads can read it, else a
    contiguous copy (never for the TMA program: ``flash_attention``)."""
    return t if _fa.strided_ok(t) else t.contiguous()


def flash_attention(q, k, v, *, causal=True, window=None):
    """Causal / sliding-window / GQA attention: q (B, H, Sq, dh), k and v
    (B, Hkv, Skv, dh) of one dtype (f32 or bf16) → o (B, H, Sq, dh) in q's
    dtype.  Query head h reads KV head h // (H / Hkv); query t attends to
    keys ≤ t (``causal``) and > t − ``window``; a query with no such key
    gives 0.  Any strides with dh contiguous are taken (a transposed
    (B, S, H, dh) view is read in place, and o keeps q's stride order).
    On the card dh must be one of ``flash_attention.HEAD_DIMS``.  The TMA
    program (bf16 at dh in ``flash_attention.WGMMA_HEAD_DIMS``) copies
    nothing and raises ``ValueError`` on strides its tensor maps cannot
    take (``flash_attention.tma_ok``); the others, as ``decode_attention``,
    read operands whose strides their vector loads cannot take from a
    contiguous copy."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype in {_DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape)
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[1] % k.shape[1]):
        raise ValueError(f"want q (B, H, Sq, dh) and k/v (B, Hkv, Skv, dh) "
                         f"with Hkv | H; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1; got {window}")
    _forward_only("flash_attention", "attn_impl", q, k, v)
    for t, name in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, {name} on {t.device}")
    kind = _device_kind(q, "flash_attention")
    if kind == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype != torch.bfloat16 or q.shape[3] not in _fa.WGMMA_HEAD_DIMS:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _kernel(kind, _fa).attend(q, k, v, causal, window)


def decode_attention(q, k_cache, v_cache, pos, shard_offset=0, window=None,
                     *, shards=None, pos_value=None):
    """Flash-decoding partials, ready for a log-sum-exp merge across
    shards: q (B, H, dh); caches (B, S, Hkv, dh) of q's dtype holding
    absolute positions [shard_offset, shard_offset + S); the token at
    ``pos`` (an int or a 0-d integer tensor) attends to positions ≤ pos
    and > pos − ``window``.  Returns (o (B, H, dh), m (B, H), l (B, H)),
    all f32: the unnormalised output, the max and the sum-exp; a cache
    with no valid position gives o = 0, l = 0, m = −1e30.

    With ``shards`` the caches are that many blocks of S/shards positions
    (the q parties' shards) and every result gains a leading shard axis,
    from one launch on the card.  There dh must be one of
    ``flash_attention.HEAD_DIMS`` and H/Hkv at most
    ``decode_attention.MAX_REP``; any S/shards is taken.  ``pos_value``:
    ``pos``'s int where ``pos`` is a tensor, read only on the fake route
    (for its FLOP tally: a fake tensor holds no value)."""
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"q and the caches must share a dtype in "
                         f"{_DTYPES}; got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    n = 1 if shards is None else int(shards)
    if (q.dim() != 3 or k_cache.dim() != 4
            or tuple(v_cache.shape) != tuple(k_cache.shape)
            or k_cache.shape[0] != q.shape[0]
            or k_cache.shape[3] != q.shape[2]
            or q.shape[1] % k_cache.shape[2] or n < 1
            or k_cache.shape[1] % n):
        raise ValueError(f"want q (B, H, dh) and caches (B, S, Hkv, dh) "
                         f"with Hkv | H and shards | S; got q "
                         f"{tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"shards {shards}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1; got {window}")
    _forward_only("decode_attention", "attn_impl", q, k_cache, v_cache, pos)
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, {name} on {t.device}")
    kind = _device_kind(q, "decode_attention")
    if kind == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos,
                                        shard_offset, window, shards)
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=q.device, dtype=torch.int32).reshape(())
    else:
        pos_t = torch.full((), int(pos), dtype=torch.int32, device=q.device)
    extra = {}
    if kind == "fake":
        if isinstance(pos, torch.Tensor) and pos_value is None:
            raise ValueError("decode_attention's fake route needs the "
                             "position's value: pass an int, or pos_value")
        extra["value"] = int(pos if pos_value is None else pos_value)
    o, m, l = _kernel(kind, _da).partials(_aligned(q), _aligned(k_cache),
                                          _aligned(v_cache), pos_t, n,
                                          int(shard_offset), window, **extra)
    return (o, m, l) if shards is not None else (o[0], m[0], l[0])
