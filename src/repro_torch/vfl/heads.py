"""The party-sharded loss and greedy decode heads (the port of
``repro.vfl.heads``).

The tied embedding table is split into q vocabulary blocks, one per
party; each block's logits are computed on their own and never joined
into the full (.., V) logits.  The greedy token is assembled from the
blocks' maxima; the loss's log-sum-exp from the blocks' Σexp under one
global maximum and its label logit from the block that owns the label
(Megatron-style parallel cross-entropy).  Its backward gives each block
ϑ = softmax − 1̂ on its own columns, and through the embedding's BUM
(``core.bum``) that cotangent reaches every party's block: the
framework-scale form of the paper's backward updating.  A plain
``torch.matmul`` takes the logits, as the reference leaves that product to
XLA.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import party_blocks


def _chunk_loss(blocks: torch.Tensor, hc: torch.Tensor,
                yc: torch.Tensor) -> torch.Tensor:
    """Σ over one sequence chunk's tokens of (LSE − label logit).
    blocks (q, V/q, D) bf16; hc (B, c, D); yc (B, c) integer labels."""
    q, v_loc = blocks.shape[:2]
    b, c, d = hc.shape
    logits = torch.matmul(hc.reshape(b * c, d).to(torch.bfloat16),
                          blocks.transpose(1, 2)).float().view(q, b, c, v_loc)
    # the global max over the blocks' maxima, held fixed in the backward
    # (the reference's stop_gradient)
    gmax = logits.detach().amax(-1).amax(0)
    lse = torch.log(torch.exp(logits - gmax[..., None]).sum(-1).sum(0)) \
        + gmax
    offset = torch.arange(q, device=yc.device).view(q, 1, 1) * v_loc
    local = yc.unsqueeze(0) - offset                        # (q, B, c)
    owns = (local >= 0) & (local < v_loc)
    ylogit = torch.gather(logits, -1,
                          local.clamp(0, v_loc - 1).unsqueeze(-1))[..., 0]
    ylogit = torch.where(owns, ylogit, 0.0).sum(0)
    return (lse - ylogit).sum()


def vocab_parallel_loss(rt: Runtime, table: torch.Tensor, h: torch.Tensor,
                        labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean token cross-entropy (0-d, f32) of h (B, S, D) against labels
    (B, S) in [0, vocab), with table (V_pad, D), party ℓ owning rows
    [ℓV/q, (ℓ+1)V/q) (``repro/vfl/heads.py:23-83``).

    Per party block: logits = h_bf16 @ block_bf16ᵀ (bf16 out, read as
    f32).  The sequence is cut into chunks of ``min(rt.loss_chunk, S)``
    positions, which must divide S; each chunk's loss is recomputed in
    the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``), so the (B, S, V) f32 logits never exist whole.
    The padded rows of the table enter the log-sum-exp, as in the
    reference; labels never reach them.  ``vocab`` is the reference's
    argument and is not read there either."""
    b, s, _ = h.shape
    chunk = min(rt.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"loss_chunk {chunk} does not divide the sequence "
                         f"length {s}")
    blocks = party_blocks(table, rt.model_size).to(torch.bfloat16)
    total = h.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, chunk):
        total = total + checkpoint(_chunk_loss, blocks, h[:, lo:lo + chunk],
                                   labels[:, lo:lo + chunk],
                                   use_reentrant=False)
    return total / (b * s)


def vocab_parallel_greedy(rt: Runtime, table: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    """h: (B, D) last-position hidden → greedy next token (B,) int64.

    Per party block: logits = h_bf16 @ block_bf16ᵀ (bf16 out, read as
    f32), the block maximum and its first argmax plus the block's offset.
    The token is the largest candidate id among the blocks that reach the
    global maximum (``repro/vfl/heads.py:86-107``)."""
    blocks = party_blocks(table, rt.model_size).to(torch.bfloat16)
    v_loc = blocks.shape[1]
    logits = torch.matmul(h.to(torch.bfloat16).unsqueeze(0),
                          blocks.transpose(1, 2)).float()   # (q, B, V/q)
    lmax = logits.amax(-1)
    offset = torch.arange(blocks.shape[0], device=h.device) * v_loc
    larg = logits.argmax(-1) + offset[:, None]
    cand = torch.where(lmax >= lmax.max(0).values, larg, -1)
    return cand.max(0).values
