"""Build, binding and launch of the hand-written CUDA ``decode_attention``
kernel.

The port of the Pallas TPU kernel ``repro.kernels.decode_attention``: one
token's attention over KV cache shards, giving each shard's unnormalised
output and its running max and sum-exp for a log-sum-exp merge.  One
launch covers every shard of a cache (B, S, Hkv, dh) seen as ``shards``
blocks of S/shards positions.  The source is ``csrc/decode_attention.cu``;
its header note says what the kernel replaces, what bounds it on the H100
and how its design answers that.

Build: ``kernels.build`` compiles the source at first launch into its own
library under ``build/kernels/`` and loads it with ``ctypes``; nothing is
built or loaded when the module is imported.

The source holds one program with one entry point per cache dtype,
templated on dh (``HEAD_DIMS``) and on the largest query-group size (at
most ``MAX_REP`` query heads per KV head).  ``KERNEL.launches
["decode_attention"]`` goes up by one exactly where it is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import SUFFIX, CudaLibrary
from repro_torch.kernels.flash_attention import (HEAD_DIMS, NO_WINDOW,
                                                 strided_ok)

PROGRAMS = ("decode_attention",)
MAX_REP = 8
_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
# q, k, v, o, m, l, pos; b, h, hkv, shards, s_loc, dh, offset, window;
# strides of q (batch, head) and of k and v (batch, position, head);
# stream
ARGTYPES = {"decode_attention": [_PTR] * 7 + [_I64] * 16 + [_PTR]}


class DecodeKernel(CudaLibrary):
    """The ``decode_attention`` library, its launch counter and the build
    report."""

    def __init__(self):
        super().__init__("decode_attention.cu", PROGRAMS, ARGTYPES)

    def partials(self, q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor, shards: int,
                 offset: int, window):
        """(o (shards, B, H, dh), m (shards, B, H), l (shards, B, H)), all
        f32, on the card: q (B, H, dh) and caches (B, S, Hkv, dh) of one
        dtype in {float32, bfloat16} on one CUDA device, each
        ``strided_ok``, S divisible by ``shards``, dh in ``HEAD_DIMS``,
        H/Hkv <= ``MAX_REP``; ``pos`` a 0-d int32 tensor on that device;
        the cache's first position is ``offset``.  Launches on the
        current stream; raises if the launch is refused."""
        b, h, dh = q.shape
        s, hkv = k_cache.shape[1], k_cache.shape[2]
        if (q.device.type != "cuda" or q.dtype not in SUFFIX
                or any(t.device != q.device or t.dtype != q.dtype
                       or not strided_ok(t) for t in (q, k_cache, v_cache))
                or k_cache.dim() != 4
                or tuple(v_cache.shape) != tuple(k_cache.shape)
                or k_cache.shape[0] != b or k_cache.shape[3] != dh
                or h % hkv or h // hkv > MAX_REP or dh not in HEAD_DIMS
                or shards < 1 or s % shards or b > 65535 or hkv > 65535
                or pos.device != q.device or pos.dtype != torch.int32
                or pos.dim() != 0 or (window is not None and window < 1)):
            raise ValueError(
                "decode_attention kernel takes CUDA q (B, H, dh) and caches "
                "(B, S, Hkv, dh) of one dtype in {float32, bfloat16} on one "
                f"device, dh in {HEAD_DIMS}, H/Hkv <= {MAX_REP}, S divisible "
                "by shards, dh contiguous and the other strides multiples "
                "of 8, a 0-d int32 pos on that device, window >= 1; got "
                + ", ".join(f"{tuple(t.shape)} {t.stride()} {t.dtype} "
                            f"{t.device}" for t in (q, k_cache, v_cache))
                + f", shards {shards}, pos {pos.dtype} {pos.device}, "
                f"window {window}")
        o = torch.empty((shards, b, h, dh), dtype=torch.float32,
                        device=q.device)
        m = torch.empty((shards, b, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        if o.numel() == 0:
            return o, m, l
        with torch.cuda.device(q.device):
            self._launch("decode_attention", q.dtype, q.data_ptr(),
                         k_cache.data_ptr(), v_cache.data_ptr(),
                         o.data_ptr(), m.data_ptr(), l.data_ptr(),
                         pos.data_ptr(), b, h, hkv, shards, s // shards, dh,
                         int(offset),
                         NO_WINDOW if window is None else int(window),
                         *q.stride()[:2], *k_cache.stride()[:3],
                         *v_cache.stride()[:3],
                         what=f"q {tuple(q.shape)} {q.dtype}, cache "
                              f"{tuple(k_cache.shape)}, {shards} shards")
        return o, m, l


KERNEL = DecodeKernel()
