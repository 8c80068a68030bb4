"""Plain PyTorch versions of the kernels (allclose targets).

The CPU path of every wrapper in ``ops`` and the yardstick the card's
kernels are held against.  On the card the main path never calls these.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (local_decode_attention,
                                          shard_partials)


def vfl_forward_ref(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z = xb @ w in f32, with the shapes ``ops.vfl_grad`` takes:
    xb (B, D) with w (D,) or (D, M), or xb (P, B, D) with w (P, D) or
    (P, D, M); a rank-1 weight gives a rank-1 (per party) z."""
    x = xb.float()
    wf = w.float()
    if xb.dim() == 3 and w.dim() == 2:
        return torch.matmul(x, wf.unsqueeze(-1)).squeeze(-1)
    return torch.matmul(x, wf)


def vfl_backward_ref(xb: torch.Tensor, theta: torch.Tensor, w=None,
                     lam: float = 0.0, denom=None) -> torch.Tensor:
    """g = xbᵀθ/denom (+ λw) in f32, with the shapes ``ops.vfl_grad``
    takes in backward mode: xb (B, D) with θ (B,) or (B, M), or xb
    (P, B, D) with θ (P, B) or (P, B, M) (an ``expand`` view for a shared
    θ); w None or shaped as g.  ``denom`` defaults to B."""
    denom = xb.shape[-2] if denom is None else denom
    rank1 = theta.dim() == xb.dim() - 1
    th = theta.float().unsqueeze(-1) if rank1 else theta.float()
    g = torch.matmul(xb.float().transpose(-1, -2), th) / denom
    if w is not None:
        g = g + lam * (w.float().unsqueeze(-1) if rank1 else w.float())
    return g.squeeze(-1) if rank1 else g


def vfl_fused_ref(xb: torch.Tensor, w: torch.Tensor, theta: torch.Tensor,
                  lam: float = 0.0, denom=None, split=None):
    """The fused mode in f32: ``(z, g)`` from one row block, with the
    shapes ``ops.vfl_grad`` takes.

    Without ``split``: z = xb·w and g = xbᵀθ/denom + λw over the same B
    rows.  With ``split``: z over rows [split, B) only and g = xb[:split]ᵀθ
    /denom over rows [0, split) only (θ has ``split`` rows); the λw term
    needs w and θ with one column count.  xb is (B, D) or (P, B, D) with
    a leading party axis; w is (D,)/(D, Mw), or (P, D)/(P, D, Mw); θ is
    (nb,)/(nb, Mθ), or (P, nb)/(P, nb, Mθ), an ``expand`` view where one θ
    is shared.  Each side squeezes to rank 1 with its own operand.
    ``denom`` defaults to the backward rows."""
    rows = xb.shape[-2] if split is None else split
    fwd = xb if split is None else xb[..., split:, :]
    bwd = xb if split is None else xb[..., :split, :]
    wl = None
    if lam != 0.0:
        gshape = bwd.shape[:-2] + (bwd.shape[-1],) + \
            theta.shape[xb.dim() - 1:]
        wl = w.reshape(gshape)
    return (vfl_forward_ref(fwd, w),
            vfl_backward_ref(bwd, theta, wl, lam,
                             rows if denom is None else denom))


def vfl_grad_ref(xb, w, theta, lam: float, denom=None):
    """Fused VFL forward partial + BUM backward (the paper's hot loop).

    Rank-k oracle: xb (B, D); w (D,) or (D, M); theta (B,) or (B, M).
    Returns (z = xb @ w, g = xbᵀθ/denom + λw) with the same rank as the
    inputs; ``denom`` defaults to B."""
    denom = xb.shape[0] if denom is None else denom
    x = xb.float()
    z = x @ w.float()
    g = x.T @ theta.float() / denom + lam * w.float()
    return z, g


def selective_scan_state(xa: torch.Tensor, dt: torch.Tensor,
                         b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                         a_log: torch.Tensor, d_skip: torch.Tensor, h0=None):
    """The mamba-1 recurrence as a sequential loop over S in f32:

        h_t = exp(Δ_t A) ⊙ h_{t−1} + (Δ_t x_t) ⊗ B_t,  y_t = h_t·C_t + D ⊙ x_t

    with A = −exp(a_log).  xa and dt (B, S, C), b_ssm and c_ssm (B, S, N),
    a_log (C, N), d_skip (C,); h0 (B, C, N) or None (zeros).  Returns
    (y (B, S, C) in xa's dtype, h_final (B, C, N) f32)."""
    a = -torch.exp(a_log.float())
    bsz, s, c = xa.shape
    x, dtf = xa.float(), dt.float()
    b, cm = b_ssm.float(), c_ssm.float()
    h = torch.zeros((bsz, c, a.shape[1]), dtype=torch.float32,
                    device=xa.device) if h0 is None else h0.float()
    ys = []
    for t in range(s):
        dt_t = dtf[:, t]
        h = torch.exp(dt_t[..., None] * a) * h \
            + (dt_t * x[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, cm[:, t]))
    y = torch.stack(ys, 1) if ys else x.new_zeros((bsz, 0, c))
    return (y + d_skip.float() * x).to(xa.dtype), h


def selective_scan(xa: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                   c_ssm: torch.Tensor, a_log: torch.Tensor,
                   d_skip: torch.Tensor) -> torch.Tensor:
    """y of :func:`selective_scan_state` from a zero state: what the
    selective-scan kernel computes, with its shapes."""
    return selective_scan_state(xa, dt, b_ssm, c_ssm, a_log, d_skip)[0]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window=None) -> torch.Tensor:
    """What the flash-attention kernel computes: q (B, H, Sq, dh), k/v
    (B, Hkv, Skv, dh) → (B, H, Sq, dh) in q's dtype; query head h reads KV
    head h // rep; query t attends to keys ≤ t (``causal``) and > t −
    ``window``.  Scores, softmax and the product with v in f32.  A query
    with no valid key gives 0, as the kernels do (the Pallas kernel's
    max(l, 1e-30)); elsewhere this is ``repro/kernels/ref.py:8``."""
    h, hkv = q.shape[1], k.shape[1]
    sq, skv, dh = q.shape[2], k.shape[2], q.shape[3]
    kk = k.repeat_interleave(h // hkv, dim=1)
    vv = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * dh ** -0.5, kk.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1) * mask
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos, shard_offset=0,
                         window=None, shards=None):
    """What the decode-attention kernel computes: the port's
    ``local_decode_attention`` on q (B, H, dh) over caches (B, S, Hkv, dh)
    whose first position is ``shard_offset``.  With ``shards`` the caches
    are that many blocks of S/shards positions and the partials gain a
    leading shard axis: o (shards, B, H, dh), m and l (shards, B, H)."""
    if shards is None:
        return local_decode_attention(q, k_cache, v_cache, pos,
                                      shard_offset, window)
    return shard_partials(q, k_cache, v_cache, pos, shards, shard_offset,
                          window)
