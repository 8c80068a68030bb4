"""Public wrappers for the port's kernels.

``vfl_grad``, ``selective_scan``, ``flash_attention`` and
``decode_attention`` keep the signatures of their counterparts in
``repro.kernels.ops`` (without Pallas's tiling and interpret arguments).
The tensors they are given decide where they run: on CUDA tensors they
launch the hand-written CUDA kernel (``kernels.vfl_grad``,
``kernels.selective_scan``, ``kernels.flash_attention``,
``kernels.decode_attention``) or raise; on CPU tensors they run the plain
version (``kernels.ref``).  Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import vfl_grad as _vg

_DTYPES = (torch.float32, torch.bfloat16)


def _contig(t: torch.Tensor) -> torch.Tensor:
    # a no-op call still costs a dispatch, and releases the interpreter
    # lock: threads that launch (core/async_engine.py) hand it over there
    return t if t.is_contiguous() else t.contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


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
    rank1 = w.dim() == xb.dim() - 1
    if xb.dim() == 2 and w.dim() in (1, 2):
        x3 = xb.unsqueeze(0)
        w3 = w.reshape(1, w.shape[0], 1 if rank1 else w.shape[1])
    elif xb.dim() == 3 and w.dim() in (2, 3) and w.shape[0] == xb.shape[0]:
        x3 = xb
        w3 = w.unsqueeze(-1) if rank1 else w
    else:
        raise ValueError(f"bad shapes xb {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}: want (B, D) with (D,)/(D, M) "
                         "or (P, B, D) with (P, D)/(P, D, M)")
    if w3.shape[1] != x3.shape[2]:
        raise ValueError(f"contraction mismatch: xb {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}")
    if xb.device.type == "cpu":
        return ref.vfl_forward_ref(xb, w)
    z = _vg.KERNEL.forward(x3, w3)
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
    rank1 = theta.dim() == xb.dim() - 1
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
    if xb.device.type == "cpu":
        return ref.vfl_backward_ref(xb, theta, w, lam, denom)
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
    g = _vg.KERNEL.backward(_contig(x3), th3, w3, lam, float(denom))
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
    if xb.device.type == "cpu":
        return ref.vfl_fused_ref(xb, w, theta, lam, denom, split)
    x3 = xb.unsqueeze(0) if lead == 0 else xb
    w3 = w.reshape(x3.shape[0], d, mw)
    th3 = theta.unsqueeze(-1) if th_rank1 else theta
    th3 = _f32(th3.unsqueeze(0) if lead == 0 else th3)
    if not (th3.stride(0) == 0 and th3[0].is_contiguous()):
        th3 = _contig(th3)                  # not a shared (expanded) θ
    z, g = _vg.KERNEL.fused(_contig(x3), _contig(w3), th3, lam,
                            float(denom), split)
    if w_rank1:
        z = z.squeeze(-1)
    if th_rank1:
        g = g.squeeze(-1)
    return (z.squeeze(0), g.squeeze(0)) if lead == 0 else (z, g)


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
    if xa.device.type == "cpu":
        return ref.selective_scan(xa, dt, b_ssm, c_ssm, a_log, d_skip)
    if xa.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{xa.device}")
    return _ss.KERNEL.scan(xa.contiguous(), *(
        t.float().contiguous() for t in (dt, b_ssm, c_ssm, a_log, d_skip)))


def _device_kind(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return t.device.type


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
    for t, name in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, {name} on {t.device}")
    if _device_kind(q, "flash_attention") == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype != torch.bfloat16 or q.shape[3] not in _fa.WGMMA_HEAD_DIMS:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _fa.KERNEL.attend(q, k, v, causal, window)


def decode_attention(q, k_cache, v_cache, pos, shard_offset=0, window=None,
                     *, shards=None):
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
    ``decode_attention.MAX_REP``; any S/shards is taken."""
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
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, {name} on {t.device}")
    if _device_kind(q, "decode_attention") == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos,
                                        shard_offset, window, shards)
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=q.device, dtype=torch.int32).reshape(())
    else:
        pos_t = torch.full((), int(pos), dtype=torch.int32, device=q.device)
    o, m, l = _da.KERNEL.partials(_aligned(q), _aligned(k_cache),
                                  _aligned(v_cache), pos_t, n,
                                  int(shard_offset), window)
    return (o, m, l) if shards is not None else (o[0], m[0], l[0])
