"""Build, binding and launch of the hand-written CUDA ``flash_attention``
kernel.

The port of the Pallas TPU kernel ``repro.kernels.flash_attention``:
causal / sliding-window / GQA softmax attention over q (B, H, Sq, dh) and
k/v (B, Hkv, Skv, dh).  The source is ``csrc/flash_attention.cu``; its
header note says what the kernel replaces, what bounds it on the H100 and
how its design answers that.

Build: ``kernels.build`` compiles the source at first launch into its own
library under ``build/kernels/`` and loads it with ``ctypes``; nothing is
built or loaded when the module is imported.

The source holds one program with one entry point per dtype, templated
on dh (``HEAD_DIMS``).  bf16 at dh in ``WGMMA_HEAD_DIMS`` runs on the
tensor cores through ``wgmma`` on K/V tiles that TMA streams in, bf16 at
dh 32 through ``mma.sync``, f32 in full f32 on the CUDA cores.  Operands
are passed by their strides, so transposed views reach the kernel without
a copy; for the TMA path the kernel builds its tensor maps from those
strides on every call, and the wrapper raises ``ValueError`` on strides
that TMA cannot take (``tma_ok``) rather than copy.  ``KERNEL.launches
["flash_attention"]`` goes up by one exactly where it is launched.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.build import SUFFIX, CudaLibrary

PROGRAMS = ("flash_attention",)
HEAD_DIMS = (32, 64, 128, 256)   # the template instances in the source
WGMMA_HEAD_DIMS = (64, 128, 256)  # bf16 instances on wgmma and TMA
NO_WINDOW = 1 << 40              # the window the kernel reads as "none"
_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
# q, k, v, o; b, h, hkv, sq, skv, dh; (batch, head, position) strides of
# q, k, v and o; causal, window; stream
ARGTYPES = {"flash_attention": [_PTR] * 4 + [_I64] * 20 + [_PTR]}


def _base(t: torch.Tensor) -> int:
    """t's first element's address for the alignment test: ``data_ptr``,
    or for a fake tensor (which has none) its byte offset into its
    storage, whose allocation the caching allocator aligns to 512 bytes."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def strided_ok(t: torch.Tensor) -> bool:
    """dh contiguous, every other stride a multiple of 8 elements and the
    base 16-byte aligned: what the kernels' vector loads need."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and _base(t) % 16 == 0)


def tma_ok(t: torch.Tensor) -> bool:
    """What the TMA tensor maps of the wgmma program take: ``strided_ok``
    (for bf16: every stride but dh's a multiple of 16 bytes, the base
    16-byte aligned), and every dimension of more than one element a
    positive stride below 2**40 bytes."""
    return strided_ok(t) and all(
        0 < st * t.element_size() < 1 << 40
        for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


class FlashKernel(CudaLibrary):
    """The ``flash_attention`` library, its launch counter and the build
    report."""

    def __init__(self):
        super().__init__("flash_attention.cu", PROGRAMS, ARGTYPES)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window) -> torch.Tensor:
        """o (B, H, Sq, dh) in q's dtype (and q's stride order) on the
        card: q (B, H, Sq, dh), k and v (B, Hkv, Skv, dh), one dtype in
        {float32, bfloat16} on one CUDA device, dh in ``HEAD_DIMS``, Hkv
        dividing H, each ``strided_ok`` (``tma_ok`` for bf16 at dh in
        ``WGMMA_HEAD_DIMS``).  ``window`` None or >= 1.  Launches on the
        current stream; raises ``ValueError`` on operands it does not
        take (it never copies them) and ``RuntimeError`` if the launch is
        refused."""
        b, h, sq, dh = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        if (q.device.type != "cuda" or q.dtype not in SUFFIX
                or any(t.device != q.device or t.dtype != q.dtype
                       or not strided_ok(t) for t in (q, k, v))
                or k.dim() != 4 or tuple(v.shape) != tuple(k.shape)
                or k.shape[0] != b or k.shape[3] != dh or h % hkv
                or dh not in HEAD_DIMS or b > 65535 or h > 65535
                or (window is not None and window < 1)):
            raise ValueError(
                "flash_attention kernel takes CUDA q (B, H, Sq, dh), k/v "
                "(B, Hkv, Skv, dh) of one dtype in {float32, bfloat16} on "
                f"one device, dh in {HEAD_DIMS}, Hkv | H, dh contiguous "
                "and the other strides multiples of 8, window >= 1; got "
                + ", ".join(f"{tuple(t.shape)} {t.stride()} {t.dtype} "
                            f"{t.device}" for t in (q, k, v))
                + f", window {window}")
        if q.dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS and not all(
                tma_ok(t) for t in (q, k, v)):
            raise ValueError(
                "flash_attention's TMA tensor maps take bf16 operands whose "
                "strides (but dh's) are positive multiples of 16 bytes "
                "below 2**40 bytes; got strides "
                + ", ".join(str(t.stride()) for t in (q, k, v)))
        o = torch.empty_like(q)
        if o.numel() == 0:
            return o
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            self._launch("flash_attention", q.dtype, q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
                         sq, skv, dh, *strides, int(causal),
                         NO_WINDOW if window is None else int(window),
                         what=f"q {tuple(q.shape)} {q.dtype}, k "
                              f"{tuple(k.shape)}")
        return o


KERNEL = FlashKernel()
