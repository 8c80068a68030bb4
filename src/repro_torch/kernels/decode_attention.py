"""Build, binding and launch of the hand-written CUDA ``decode_attention``
kernel.

The port of the Pallas TPU kernel ``repro.kernels.decode_attention``: one
token's attention over KV cache shards, giving each shard's unnormalised
output and its running max and sum-exp for a log-sum-exp merge.  One
launch covers every shard of a cache (B, S, Hkv, dh) seen as ``shards``
blocks of S/shards positions, each cut into chunks (``chunk_plan``) that
separate blocks stream; a shard's chunk partials are merged in the kernel,
in chunk order.  The source is ``csrc/decode_attention.cu``; its header
note says what the kernel replaces, what bounds it on the H100 and how its
design answers that.

Build: ``kernels.build`` compiles the source at first launch into its own
library under ``build/kernels/`` and loads it with ``ctypes``; nothing is
built or loaded when the module is imported.

The source holds one program with one entry point per cache dtype (bf16:
tensor cores through ``mma.sync``; f32: CUDA cores), templated on dh
(``HEAD_DIMS``); the query-group size (at most ``MAX_REP`` query heads
per KV head) is read at run time.  ``KERNEL.launches
["decode_attention"]`` goes up by one exactly where it is launched.

The wrapper hands the kernel an f32 workspace for the chunk partials,
allocated per call, and the merge's ticket counters, one int32 per
(shard, KV head, batch row), which it keeps per device: they hold zeros
between launches (the merging block resets its own), so a captured decode
step replays with no reset of its own.  No counter buffer is ever freed,
so a graph captured with one stays valid.  Launches on one device share
the counters, so they must not run concurrently on two streams.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import SUFFIX, CudaLibrary
from repro_torch.kernels.flash_attention import (HEAD_DIMS, NO_WINDOW,
                                                 strided_ok)

PROGRAMS = ("decode_attention",)
MAX_REP = 8
CHUNK = 64                       # most positions a block owns (4 warps x 16)
MIN_COUNTERS = 1 << 14           # ticket counters kept per device, at least
_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
# q, k, v, o, m, l, workspace, counters, pos; b, h, hkv, shards, s_loc,
# dh, offset, window, chunks, chunk_len; strides of q (batch, head) and of
# k and v (batch, position, head); stream
ARGTYPES = {"decode_attention": [_PTR] * 9 + [_I64] * 18 + [_PTR]}


def chunk_plan(s_loc: int, target: int = CHUNK):
    """(chunks, chunk_len): a shard of ``s_loc`` positions cut into
    ``chunks`` runs of ``chunk_len`` positions, at most ``target`` each and
    as even as whole positions allow; the last run holds the rest and is
    never empty.  It depends on the shapes only, so a captured step can
    advance pos."""
    chunks = -(-s_loc // target)
    return chunks, -(-s_loc // chunks)


class DecodeKernel(CudaLibrary):
    """The ``decode_attention`` library, its launch counter and the build
    report."""

    def __init__(self):
        super().__init__("decode_attention.cu", PROGRAMS, ARGTYPES)
        self._counters = {}   # device index -> int32 zeros, oldest first

    def counters(self, device: torch.device, n: int) -> torch.Tensor:
        """At least ``n`` ticket counters on ``device``, all 0: the
        device's newest buffer, or a larger one made now.  Every buffer is
        kept for the life of the process, since a graph captured with it
        holds its address (one made during a capture is also zeroed inside
        that graph)."""
        kept = self._counters.setdefault(device.index, [])
        if kept and kept[-1].numel() >= n:
            return kept[-1]
        kept.append(torch.zeros(max(n, MIN_COUNTERS), dtype=torch.int32,
                                device=device))
        return kept[-1]

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
        s_loc = s // shards
        chunks, chunk_len = chunk_plan(s_loc)
        with torch.cuda.device(q.device):
            ws = torch.empty((shards, chunks, b, h, dh + 2),
                             dtype=torch.float32, device=q.device)
            count = self.counters(q.device, shards * hkv * b)
            self._launch("decode_attention", q.dtype, q.data_ptr(),
                         k_cache.data_ptr(), v_cache.data_ptr(),
                         o.data_ptr(), m.data_ptr(), l.data_ptr(),
                         ws.data_ptr(), count.data_ptr(), pos.data_ptr(), b,
                         h, hkv, shards, s_loc, dh, int(offset),
                         NO_WINDOW if window is None else int(window),
                         chunks, chunk_len,
                         *q.stride()[:2], *k_cache.stride()[:3],
                         *v_cache.stride()[:3],
                         what=f"q {tuple(q.shape)} {q.dtype}, cache "
                              f"{tuple(k_cache.shape)}, {shards} shards")
        return o, m, l


KERNEL = DecodeKernel()
