"""The party-sharded greedy decode head (the port of
``repro.vfl.heads.vocab_parallel_greedy``).

The tied embedding table is split into q vocabulary blocks, one per
party; each block's logits are computed on their own, and the greedy
token is assembled from the blocks' maxima.  A plain ``torch.matmul``
takes the logits, as the reference leaves that product to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import party_blocks


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
