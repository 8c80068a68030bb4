"""Build, binding and launch of the hand-written CUDA ``vfl_grad`` kernel.

The port of the Pallas TPU kernel ``repro.kernels.vfl_grad`` (its forward
mode; backward, fused and split-batch forms come with the training slice).
The source is ``csrc/vfl_grad.cu``; its header note says what the kernel
replaces, what bounds it on the H100 and how its design answers that.

Build: at first launch, ``nvcc -gencode arch=compute_90a,code=sm_90a``
compiles the source into a shared library with a plain C interface under
``build/kernels/`` at the repository root (git-ignored), named by a hash
of the source and flags, so an edited source is rebuilt and an unchanged
one is reused.  The library is loaded with ``ctypes``.  Nothing is built or
loaded when the module is imported.

The source holds two ``__global__`` programs, each with its own entry
points: ``vfl_forward_narrow`` (M <= ``NARROW_MAX_M``, the linear path) and
``vfl_forward_wide`` (wider M, the deep encoder layers).  ``forward`` picks
one by M.  ``KERNEL.launches`` maps each program's name to its launch
count: a count goes up by one exactly where that program is launched, so a
run can show that its path went through it.  ``reset_launches`` zeroes
them.
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

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "vfl_grad.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NARROW_MAX_M = 4                 # kNarrow in csrc/vfl_grad.cu
PROGRAMS = ("vfl_forward_narrow", "vfl_forward_wide")
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
        lib = ctypes.CDLL(str(path))
        for prog in PROGRAMS:
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"{prog}_{suffix}")
                fn.argtypes = [ctypes.c_void_p] * 3 \
                    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        return lib

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
        fn = getattr(self.library(), f"{prog}_{_SUFFIX[x.dtype]}")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), w.data_ptr(), z.data_ptr(), p, b, d, m,
                     stream)
        if err != 0:
            raise RuntimeError(f"{prog} launch failed: CUDA error {err} at "
                               f"x {tuple(x.shape)}, w {tuple(w.shape)}, "
                               f"{x.dtype}")
        with self._lock:
            self.launches[prog] += 1
        return z


KERNEL = CudaKernel()
