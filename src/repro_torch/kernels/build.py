"""Build, load and launch bookkeeping shared by the port's CUDA sources.

Each source under ``csrc/`` builds into a shared library of its own with a
plain C interface.  At first use, ``nvcc -gencode
arch=compute_90a,code=sm_90a`` compiles it under ``build/kernels/`` at the
repository root (git-ignored), named by the source's stem and a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused.  The library is loaded with ``ctypes``.  Nothing is built or loaded
when a module is imported.

``CudaLibrary`` holds one such library: its build report, its entry points
(``<program>_<dtype suffix>``) and one launch counter per program.  A count
goes up by one exactly where its program is launched, so a run can show
that its path went through it.
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
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the port's CUDA kernels cannot "
                       "be built")


class CudaLibrary:
    """One CUDA source's library, its launch counters and build report.

    ``argtypes`` maps each program to the ctypes argument list of its entry
    points (one per dtype suffix), the stream last."""

    def __init__(self, source: str, programs: Sequence[str],
                 argtypes: Dict[str, list]):
        self.source = CSRC / source
        self.programs = tuple(programs)
        self._argtypes = argtypes
        self.launches = dict.fromkeys(self.programs, 0)
        self.build_seconds = None     # wall time of the nvcc run, if any
        self.build_log = ""           # nvcc's -Xptxas -v report
        self._lib = None
        self._lock = threading.Lock()

    def reset_launches(self) -> None:
        with self._lock:
            self.launches = dict.fromkeys(self.programs, 0)

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
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"lib{self.source.stem}_{tag[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                   str(self.source)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on "
                                   f"{self.source.name}:\n{proc.stderr}")
            os.replace(tmp, out)      # atomic: a reader never sees half
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        return out

    def _load(self, path: Path):
        lib = ctypes.CDLL(str(path))
        for prog in self.programs:
            for suffix in SUFFIX.values():
                fn = getattr(lib, f"{prog}_{suffix}")
                fn.argtypes = self._argtypes[prog]
                fn.restype = ctypes.c_int
        return lib

    def _launch(self, prog: str, dtype, *args, what) -> None:
        """Call ``prog``'s entry point for ``dtype`` on the current stream
        of the current device; raise if the launch was refused, else count
        it.  ``what`` (a string, or a function that makes it only when the
        launch fails) names the operands in the error."""
        fn = getattr(self.library(), f"{prog}_{SUFFIX[dtype]}")
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{prog} launch failed: CUDA error {err} at "
                               f"{what() if callable(what) else what}")
        with self._lock:
            self.launches[prog] += 1
