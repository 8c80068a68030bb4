"""Build, binding and launch of the hand-written CUDA ``selective_scan``
kernel.

The port of the Pallas TPU kernel ``repro.kernels.selective_scan``: the
mamba-1 recurrence from a zero state, returning y only.  The source is
``csrc/selective_scan.cu``; its header note says what the kernel replaces,
what bounds it on the H100 and how its design answers that.

Build: ``kernels.build`` compiles the source at first launch into its own
library under ``build/kernels/`` and loads it with ``ctypes``; nothing is
built or loaded when the module is imported.

The source holds one ``__global__`` program, templated on the state size
N (``STATE_SIZES``), with one entry point per xa dtype.  Two lanes share
a channel, each holding half of its states; a block stages xa, dt, B and
C in shared memory a chunk of steps ahead with asynchronous copies, and
the two lanes' partial outputs are added by one warp shuffle in a fixed
order, so two calls give the same bits.  The launcher refuses batches of
more than ``MAX_ROWS`` rows (its grid's second dimension).
``KERNEL.launches["selective_scan"]`` goes up by one exactly where it is
launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import SUFFIX, CudaLibrary

PROGRAMS = ("selective_scan",)
STATE_SIZES = (4, 8, 16)         # the template instances in the source
MAX_ROWS = 65535                 # kMaxRows in the source: batch rows
_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
# xa, dt, b_ssm, c_ssm, a_log, d_skip, y; batch, steps, channels, state;
# stream
ARGTYPES = {"selective_scan": [_PTR] * 7 + [_I64] * 4 + [_PTR]}


class ScanKernel(CudaLibrary):
    """The ``selective_scan`` library, its launch counter and the build
    report."""

    def __init__(self):
        super().__init__("selective_scan.cu", PROGRAMS, ARGTYPES)

    def scan(self, xa: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
             c_ssm: torch.Tensor, a_log: torch.Tensor,
             d_skip: torch.Tensor) -> torch.Tensor:
        """y (B, S, C) in xa's dtype on the card: xa (B, S, C) f32 or
        bf16, dt (B, S, C), b_ssm and c_ssm (B, S, N), a_log (C, N) and
        d_skip (C,) f32, all contiguous on one CUDA device, N in
        ``STATE_SIZES``.  Launches on the current stream; raises if the
        launch is refused."""
        bsz, s, c = xa.shape
        n = a_log.shape[-1]
        others = (dt, b_ssm, c_ssm, a_log, d_skip)
        if (xa.device.type != "cuda" or xa.dtype not in SUFFIX
                or not xa.is_contiguous()
                or any(t.device != xa.device or t.dtype != torch.float32
                       or not t.is_contiguous() for t in others)
                or tuple(dt.shape) != (bsz, s, c)
                or tuple(b_ssm.shape) != (bsz, s, n)
                or tuple(c_ssm.shape) != (bsz, s, n)
                or tuple(a_log.shape) != (c, n)
                or tuple(d_skip.shape) != (c,) or n not in STATE_SIZES
                or bsz > MAX_ROWS):
            raise ValueError(
                "selective_scan kernel takes contiguous CUDA xa (B, S, C) in "
                "{float32, bfloat16}, f32 dt (B, S, C), b/c (B, S, N), a_log "
                f"(C, N), d_skip (C,) on one device, N in {STATE_SIZES}, "
                f"B <= {MAX_ROWS}; got xa {tuple(xa.shape)} {xa.dtype} "
                f"{xa.device}, " + ", ".join(
                    f"{tuple(t.shape)} {t.dtype} {t.device}"
                    for t in others))
        y = torch.empty_like(xa)
        if y.numel() == 0:
            return y
        with torch.cuda.device(xa.device):
            self._launch("selective_scan", xa.dtype, xa.data_ptr(),
                         dt.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
                         a_log.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                         bsz, s, c, n,
                         what=f"xa {tuple(xa.shape)} {xa.dtype}, N {n}")
        return y


KERNEL = ScanKernel()
