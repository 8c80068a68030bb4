"""Build, binding and launch of the hand-written CUDA ``vfl_grad`` kernel.

The port of the Pallas TPU kernel ``repro.kernels.vfl_grad``: its forward,
backward and fused modes, the last with its split-batch form.  The source
is ``csrc/vfl_grad.cu``; its header note says what the kernel replaces,
what bounds it on the H100 and how its design answers that.

Build: at first launch, ``nvcc -gencode arch=compute_90a,code=sm_90a``
compiles the source into a shared library with a plain C interface under
``build/kernels/`` at the repository root (git-ignored), named by a hash
of the source and flags, so an edited source is rebuilt and an unchanged
one is reused.  The library is loaded with ``ctypes``.  Nothing is built or
loaded when the module is imported.

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
``KERNEL.launches`` maps each program's name to its
launch count: a count goes up by one exactly where that program is
launched, so a run can show that its path went through it.
``reset_launches`` zeroes them; ``add_launches`` records launches that a
CUDA graph replays (a graph launches its kernels without calling back
into Python).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "vfl_grad.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NARROW_MAX_M = 4                 # kNarrow in csrc/vfl_grad.cu
BWD_CHUNK_ROWS = 1024            # kChunkRows in csrc/vfl_grad.cu
PROGRAMS = ("vfl_forward_narrow", "vfl_forward_wide", "vfl_backward_rows",
            "vfl_backward_reduce")
PROGRAMS += ("vfl_fused_split",)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the vfl_grad CUDA kernel "
                       "cannot be built")


class CudaKernel:
    """The built library, its launch counters and the build report."""

    def __init__(self):
        self.launches = dict.fromkeys(PROGRAMS, 0)
        self.build_seconds = None     # wall time of the nvcc run, if any
        self.build_log = ""           # nvcc's -Xptxas -v report
        self._lib = None
        self._lock = threading.Lock()

    def reset_launches(self) -> None:
        with self._lock:
            self.launches = dict.fromkeys(PROGRAMS, 0)

    def add_launches(self, per_call: dict, calls: int) -> None:
        """Count ``calls`` replays of a captured sequence that launches
        ``per_call[program]`` times each program."""
        with self._lock:
            for prog, k in per_call.items():
                self.launches[prog] += k * calls

    def library(self):
        """Build (or reuse) and load the shared library; thread-safe."""
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> Path:
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"libvfl_grad_{tag[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                   str(SOURCE)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on "
                                   f"{SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, out)      # atomic: a reader never sees half
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        return out

    @staticmethod
    def _load(path: Path):
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        argtypes = {
            "vfl_forward_narrow": [ptr] * 3 + [i64] * 4 + [ptr],
            "vfl_forward_wide": [ptr] * 3 + [i64] * 4 + [ptr],
            # x, theta, w, out; parties, rows, d, m, theta party stride;
            # denom, lam; stream
            "vfl_backward_rows": [ptr] * 4 + [i64] * 5 + [f32] * 2 + [ptr],
            # workspace, w, g; parties, d, m, chunks; denom, lam; stream
            "vfl_backward_reduce": [ptr] * 3 + [i64] * 4 + [f32] * 2 + [ptr],
            # x, w, theta, z, out; parties, rows, first forward row,
            # forward rows, backward rows, d, mw, mth, theta party stride;
            # denom, lam; lam*w on; stream
            "vfl_fused_split": [ptr] * 5 + [i64] * 9 + [f32] * 2
            + [ctypes.c_int, ptr],
        }
        lib = ctypes.CDLL(str(path))
        for prog in PROGRAMS:
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"{prog}_{suffix}")
                fn.argtypes = argtypes[prog]
                fn.restype = ctypes.c_int
        return lib

    def _launch(self, prog: str, dtype, *args, what: str) -> None:
        """Call ``prog``'s entry point for ``dtype`` on the current stream
        of the current device; raise if the launch was refused, else count
        it."""
        fn = getattr(self.library(), f"{prog}_{_SUFFIX[dtype]}")
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{prog} launch failed: CUDA error {err} at "
                               f"{what}")
        with self._lock:
            self.launches[prog] += 1

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
