"""GQA attention (the port of ``repro.models.attention``): the chunked
prefill path, the naive oracle, and decode against a KV cache whose
sequence axis is sharded over the q parties.

* ``chunked_attention``: softmax attention computed a query chunk at a
  time, with causal masking, a sliding window (gemma3's local layers) and
  GQA head groups (query head h reads KV head h // rep).  It is the plain
  counterpart of the flash-attention kernel (``kernels.ops``), which the
  model runs in its place under ``Runtime.attn_impl="kernel"``.
* ``local_decode_attention``: one token against one party's cache shard,
  giving the unnormalised output, the running max and the sum-exp of the
  shard, and ``merge_partial_attention`` combines the shards' partials by
  log-sum-exp: the partial-result aggregation of Algorithm 1, unmasked at
  serving time.  The q shards are a leading tensor dimension here, in
  place of the reference's ``pmax``/``psum`` over a mesh axis.

Layouts are the reference's: q (B, S, H, dh), k/v (B, S, Hkv, dh).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def apply_rope_positions(x: torch.Tensor, positions: torch.Tensor,
                         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding at explicit positions.  x: (B, S, H, dh);
    positions: (B, S) or (1, S) integers (broadcast over the batch)."""
    return apply_rope(x, positions.expand(x.shape[:2]), theta)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def _chunk_attention(qc: torch.Tensor, kf: torch.Tensor, v: torch.Tensor,
                     qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                     window: Optional[int], scale: float) -> torch.Tensor:
    """One query chunk qc (B, chunk, Hkv, rep, dh) against the f32 keys
    kf and the values v: its scores, mask, softmax and p·v."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", qc.float() * scale, kf)
    s = s.masked_fill(~_mask(qpos, kpos, causal, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype), v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hkv, dh) → (B, Sq, H, dh) in v's
    dtype.

    ``window``: query t attends to keys in (t − window, t].  ``q_offset``:
    the absolute position of q[0].  Scores and softmax in f32; the
    probabilities are cast to v's dtype before the product with v, as in
    the reference (``repro/models/attention.py:76``).  Under autograd each
    chunk runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward, as the reference's ``jax.checkpoint`` of its chunk body
    (``:78-81``): no chunk's (chunk × Skv) probabilities are kept."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    rep = h // hkv
    chunk = min(chunk, sq)
    if sq % chunk:
        raise ValueError(f"chunk {chunk} does not divide Sq {sq}")
    scale = dh ** -0.5
    kf = k.float()
    kpos = torch.arange(skv, device=q.device)
    qr = q.reshape(b, sq // chunk, chunk, hkv, rep, dh)
    grad = torch.is_grad_enabled()
    out = []
    for i in range(sq // chunk):
        qpos = q_offset + i * chunk + torch.arange(chunk, device=q.device)
        args = (qr[:, i], kf, v, qpos, kpos, causal, window, scale)
        out.append(checkpoint(_chunk_attention, *args, use_reentrant=False,
                              preserve_rng_state=False) if grad
                   else _chunk_attention(*args))
    return torch.stack(out, 1).reshape(b, sq, h, dh)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """The naive O(S²)-memory oracle, shapes as ``chunked_attention``."""
    rep = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(rep, dim=2)
    vv = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * q.shape[-1] ** -0.5,
                     kk.float())
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(~_mask(qpos, kpos, causal, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), vv)


# ---------------------------------------------------------------------------
# decode against a sequence-sharded cache
# ---------------------------------------------------------------------------

def local_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos, shard_offset,
                           window: Optional[int] = None):
    """Partial decode attention over one cache shard.

    q: (B, H, dh); caches: (B, S_loc, Hkv, dh) holding absolute positions
    [shard_offset, shard_offset + S_loc); the token at ``pos`` attends to
    positions ≤ pos (and > pos − window).  Returns (o (B, H, dh), m (B, H),
    l (B, H)) in f32: the unnormalised weighted values, the max and the
    sum-exp over the shard.  A shard with no valid position gives o = 0,
    l = 0 and m = −1e30."""
    b, s_loc, hkv, dh = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float() * dh ** -0.5,
                     k_cache.float())
    kpos = shard_offset + torch.arange(s_loc, device=q.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1)                                          # (B, Hkv, rep)
    p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(b, h, dh), m.reshape(b, h), l.reshape(b, h)


def shard_partials(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos, shards: int,
                   shard_offset=0, window: Optional[int] = None):
    """``local_decode_attention`` on each of ``shards`` blocks of S/shards
    positions of the caches (B, S, Hkv, dh), the first at
    ``shard_offset``: the q parties' partials, stacked on a leading shard
    axis (o (P, B, H, dh), m and l (P, B, H))."""
    s_loc = k_cache.shape[1] // shards
    parts = [local_decode_attention(
        q, k_cache[:, i * s_loc:(i + 1) * s_loc],
        v_cache[:, i * s_loc:(i + 1) * s_loc], pos,
        shard_offset + i * s_loc, window) for i in range(shards)]
    return tuple(torch.stack(t) for t in zip(*parts))


def merge_partial_attention(o: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp merge of the shards' partials over the leading shard
    axis: o (P, B, H, dh), m and l (P, B, H) → (B, H, dh) f32.

    With m* = max over shards, out = Σ o_i·e^(m_i − m*) / Σ l_i·e^(m_i −
    m*); a shard with l = 0 weighs nothing."""
    corr = torch.exp(m - m.amax(0))
    o_sum = (o * corr[..., None]).sum(0)
    l_sum = (l * corr).sum(0)
    return o_sum / torch.clamp(l_sum[..., None], min=1e-30)


def cache_scatter(cache: torch.Tensor, new: torch.Tensor, pos,
                  shard_offset) -> torch.Tensor:
    """A copy of the shard ``cache`` (B, S_loc, Hkv, dh) with ``new``
    (B, Hkv, dh) written at absolute position ``pos`` if the shard owns
    it; an unchanged copy otherwise (the reference's functional update).
    The model's decode step writes its one-device cache in place
    instead."""
    out = cache.clone()
    local = int(pos) - int(shard_offset)
    if 0 <= local < cache.shape[1]:
        out[:, local] = new.to(cache.dtype)
    return out
