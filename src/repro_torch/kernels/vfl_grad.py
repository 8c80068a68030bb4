"""Build, binding and launch of the hand-written CUDA ``vfl_grad`` kernel.

The port of the Pallas TPU kernel ``repro.kernels.vfl_grad``: its forward,
backward and fused modes, the last with its split-batch form.  The source
is ``csrc/vfl_grad.cu``; its header note says what the kernel replaces,
what bounds it on the H100 and how its design answers that.

Build: ``kernels.build`` compiles the source at first launch into its own
library under ``build/kernels/`` and loads it with ``ctypes``; nothing
is built or loaded when the module is imported.

The source holds five ``__global__`` programs, each with its own entry
points: ``vfl_forward_narrow`` (M <= ``NARROW_MAX_M``, the linear path) and
``vfl_forward_wide`` (wider M, the deep encoder layers), which ``forward``
picks by M; ``vfl_backward_rows`` and ``vfl_backward_reduce``, which
``backward`` launches: the rows program alone when B fits one chunk of
``BWD_CHUNK_ROWS`` rows (every minibatch step), else the rows program into
a workspace of per-chunk partials and the reduce program over it (the
full-dataset passes); and ``vfl_fused_split``, which ``fused`` launches
for the fused mode and its split-batch form (the pipelined step): the
forward side and the backward side in one launch, followed by the reduce
program only when the backward side spans more than one chunk.

The narrow forward (``vfl_forward_narrow`` and the fused program's
forward blocks at Mw <= ``NARROW_MAX_M``) sums each row in an order set
by D, M, the column and the dtype alone: each lane owns fixed 16-byte
groups of the row.  So a row gives the same bits in any launch: a
serving dispatch and its cache hit, the fused mode's z and the forward
mode's, an epoch and its replay.  The source's launcher picks one row a
warp at the minibatch steps and several rows a warp, read through the
streaming cache path, over the full dataset; a contiguous x or w whose
pointer is off the 16-byte vector width is read element by element.

``KERNEL.launches`` maps each program's name to its
launch count: a count goes up by one exactly where that program is
launched, so a run can show that its path went through it.
``reset_launches`` zeroes them; ``add_launches`` records launches that a
CUDA graph replays (a graph launches its kernels without calling back
into Python).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import SUFFIX as _SUFFIX
from repro_torch.kernels.build import CudaLibrary

NARROW_MAX_M = 4                 # kNarrow in csrc/vfl_grad.cu
BWD_CHUNK_ROWS = 1024            # kChunkRows in csrc/vfl_grad.cu
PROGRAMS = ("vfl_forward_narrow", "vfl_forward_wide", "vfl_backward_rows",
            "vfl_backward_reduce")
PROGRAMS += ("vfl_fused_split",)

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
ARGTYPES = {
    "vfl_forward_narrow": [_PTR] * 3 + [_I64] * 4 + [_PTR],
    "vfl_forward_wide": [_PTR] * 3 + [_I64] * 4 + [_PTR],
    # x, theta, w, out; parties, rows, d, m, theta party stride; denom, lam;
    # stream
    "vfl_backward_rows": [_PTR] * 4 + [_I64] * 5 + [_F32] * 2 + [_PTR],
    # workspace, w, g; parties, d, m, chunks; denom, lam; stream
    "vfl_backward_reduce": [_PTR] * 3 + [_I64] * 4 + [_F32] * 2 + [_PTR],
    # x, w, theta, z, out; parties, rows, first forward row, forward rows,
    # backward rows, d, mw, mth, theta party stride; denom, lam; lam*w on;
    # stream
    "vfl_fused_split": [_PTR] * 5 + [_I64] * 9 + [_F32] * 2
    + [ctypes.c_int, _PTR],
}


class CudaKernel(CudaLibrary):
    """The ``vfl_grad`` library, its launch counters and the build
    report."""

    def __init__(self):
        super().__init__("vfl_grad.cu", PROGRAMS, ARGTYPES)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """z = x @ w per party on the card: x (P, B, D), w (P, D, M), both
        contiguous CUDA tensors of one dtype (f32 or bf16) -> z (P, B, M)
        f32.  Launches the narrow program for M <= ``NARROW_MAX_M``, else
        the wide one, on the current stream; raises if the launch is
        refused."""
        p, b, d = x.shape
        m = w.shape[2]
        if (x.device.type != "cuda" or w.device != x.device
                or x.dtype not in _SUFFIX or w.dtype != x.dtype
                or w.shape[:2] != (p, d)
                or not (x.is_contiguous() and w.is_contiguous())):
            raise ValueError(
                "vfl_grad kernel takes contiguous CUDA x (P, B, D) and "
                "w (P, D, M) of one dtype in {float32, bfloat16} on one "
                f"device; got x {tuple(x.shape)} {x.dtype} {x.device}, "
                f"w {tuple(w.shape)} {w.dtype} {w.device}")
        z = torch.empty((p, b, m), dtype=torch.float32, device=x.device)
        if z.numel() == 0:
            return z
        prog = PROGRAMS[0] if m <= NARROW_MAX_M else PROGRAMS[1]
        with torch.cuda.device(x.device):
            self._launch(prog, x.dtype, x.data_ptr(), w.data_ptr(),
                         z.data_ptr(), p, b, d, m,
                         what=f"x {tuple(x.shape)}, w {tuple(w.shape)}, "
                              f"{x.dtype}")
        return z

    def backward(self, x: torch.Tensor, theta: torch.Tensor,
                 w: Optional[torch.Tensor], lam: float,
                 denom: float) -> torch.Tensor:
        """g = x^T theta / denom (+ lam * w) per party on the card: x
        (P, B, D) contiguous f32 or bf16; theta (P, B, M) f32 whose
        (B, M) slices are contiguous, with a party stride that may be 0
        (one theta shared by every party, an ``expand`` view); w None or
        (P, D, M) contiguous of x's dtype -> g (P, D, M) f32.  Launches
        ``vfl_backward_rows`` and, when B spans more than one chunk of
        ``BWD_CHUNK_ROWS`` rows, ``vfl_backward_reduce`` over the per-chunk
        partials; raises if a launch is refused."""
        p, b, d = x.shape
        m = theta.shape[2]
        pstride = theta.stride(0)
        if (x.device.type != "cuda" or x.dtype not in _SUFFIX
                or not x.is_contiguous() or theta.device != x.device
                or theta.dtype != torch.float32
                or tuple(theta.shape) != (p, b, m)
                or not theta[0].is_contiguous()
                or (p > 1 and pstride not in (0, b * m))
                or (w is not None and (w.device != x.device
                                       or w.dtype != x.dtype
                                       or tuple(w.shape) != (p, d, m)
                                       or not w.is_contiguous()))):
            raise ValueError(
                "vfl_grad backward takes contiguous CUDA x (P, B, D) in "
                "{float32, bfloat16}, f32 theta (P, B, M) with contiguous "
                "(B, M) slices and party stride 0 or B*M, and w None or "
                "(P, D, M) of x's dtype, on one device; got x "
                f"{tuple(x.shape)} {x.dtype} {x.device}, theta "
                f"{tuple(theta.shape)} {theta.dtype} stride "
                f"{theta.stride()}, w "
                f"{None if w is None else (tuple(w.shape), w.dtype)}")
        g = torch.empty((p, d, m), dtype=torch.float32, device=x.device)
        if g.numel() == 0:
            return g
        chunks = -(-b // BWD_CHUNK_ROWS)
        out = g if chunks == 1 else torch.empty(
            (chunks, p, d, m), dtype=torch.float32, device=x.device)
        wp = 0 if w is None else w.data_ptr()
        what = (f"x {tuple(x.shape)}, theta {tuple(theta.shape)}, "
                f"{x.dtype}")
        with torch.cuda.device(x.device):
            self._launch("vfl_backward_rows", x.dtype, x.data_ptr(),
                         theta.data_ptr(), wp, out.data_ptr(), p, b, d, m,
                         pstride if p > 1 else b * m, denom, lam, what=what)
            if chunks > 1:
                self.reduce(out, w, g, denom, lam)
        return g

    def reduce(self, ws: torch.Tensor, w: Optional[torch.Tensor],
               g: torch.Tensor, denom: float, lam: float) -> torch.Tensor:
        """g = sum over chunks of ws (chunks, P, D, M), in chunk order,
        / denom (+ lam * w): the second pass of a multi-chunk ``backward``
        (exposed so it can be timed alone).  Writes and returns g."""
        chunks, p, d, m = ws.shape
        with torch.cuda.device(ws.device):
            self._launch("vfl_backward_reduce",
                         torch.float32 if w is None else w.dtype,
                         ws.data_ptr(), 0 if w is None else w.data_ptr(),
                         g.data_ptr(), p, d, m, chunks, denom, lam,
                         what=f"workspace {tuple(ws.shape)}")
        return g


    def fused(self, x: torch.Tensor, w: torch.Tensor, theta: torch.Tensor,
              lam: float, denom: float, split: Optional[int]):
        """The fused mode on the card, one launch for every party: x
        (P, B, D) and w (P, D, Mw) contiguous of one dtype (f32 or bf16);
        theta (P, Bb, Mθ) f32 with contiguous (Bb, Mθ) slices and a party
        stride of 0 or Bb·Mθ.  Without ``split`` both sides run over all
        B rows (Bb = B, Mw = Mθ) and g carries λ·w; with ``split`` the
        backward side is rows [0, split) (Bb = split) and the forward side
        rows [split, B), and λ·w needs Mw = Mθ (else pass λ = 0).  Returns
        (z (P, B − split or B, Mw), g (P, D, Mθ)), both f32.  Launches
        ``vfl_fused_split`` and, when the backward side spans more than
        one chunk of ``BWD_CHUNK_ROWS`` rows, ``vfl_backward_reduce`` over
        its per-chunk partials; raises if a launch is refused."""
        p, b, d = x.shape
        mw, nb, mth = w.shape[2], theta.shape[1], theta.shape[2]
        f0 = 0 if split is None else split
        pstride = theta.stride(0)
        lamw = lam != 0.0
        if (x.device.type != "cuda" or x.dtype not in _SUFFIX
                or not (x.is_contiguous() and w.is_contiguous())
                or w.device != x.device or w.dtype != x.dtype
                or tuple(w.shape) != (p, d, mw)
                or theta.device != x.device
                or theta.dtype != torch.float32 or theta.shape[0] != p
                or nb != (b if split is None else split)
                or not 0 <= f0 < b or not theta[0].is_contiguous()
                or (p > 1 and pstride not in (0, nb * mth))
                or (lamw and mw != mth)):
            raise ValueError(
                "vfl_grad fused takes contiguous CUDA x (P, B, D) and w "
                "(P, D, Mw) of one dtype in {float32, bfloat16}, f32 theta "
                "(P, Bb, Mθ) with Bb = split (or B) rows, contiguous "
                "(Bb, Mθ) slices and party stride 0 or Bb*Mθ, and Mw = Mθ "
                f"for λw, on one device; got x {tuple(x.shape)} {x.dtype} "
                f"{x.device}, w {tuple(w.shape)} {w.dtype}, theta "
                f"{tuple(theta.shape)} {theta.dtype} stride "
                f"{theta.stride()}, split {split}, lam {lam}")
        z = torch.empty((p, b - f0, mw), dtype=torch.float32,
                        device=x.device)
        g = torch.empty((p, d, mth), dtype=torch.float32, device=x.device)
        chunks = -(-nb // BWD_CHUNK_ROWS)
        out = g if chunks == 1 else torch.empty(
            (chunks, p, d, mth), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            self._launch("vfl_fused_split", x.dtype, x.data_ptr(),
                         w.data_ptr(), theta.data_ptr(), z.data_ptr(),
                         out.data_ptr(), p, b, f0, b - f0, nb, d, mw, mth,
                         pstride if p > 1 else nb * mth, denom, lam,
                         int(lamw),
                         what=f"x {tuple(x.shape)}, w {tuple(w.shape)}, "
                              f"theta {tuple(theta.shape)}, split {split}, "
                              f"{x.dtype}")
            if chunks > 1:
                self.reduce(out, w if lamw else None, g, denom, lam)
        return z, g

KERNEL = CudaKernel()
