"""Secure VFL frontend of the token models (the port of
``repro.vfl.embed``'s ``secure_vocab_embed``).

The raw input feature space of a token model is the vocabulary one-hot
space, and each party owns a disjoint block of the embedding table's
rows.  A lookup is each party's partial (its row where it owns the token,
zeros otherwise), and the embedding is their masked sum (Algorithm 1)
with the BUM backward (``core.bum.secure_vfl_reduce``): every party
receives ϑ = ∂L/∂(embedding) and accumulates its own block's gradient.
The q parties are the leading dimension of the partial.
"""
from __future__ import annotations

import torch

from repro_torch.core.bum import secure_vfl_reduce
from repro_torch.sharding.api import Runtime


def party_blocks(table: torch.Tensor, q: int) -> torch.Tensor:
    """The (V, D) table viewed as q vocabulary blocks (q, V/q, D)."""
    v = table.shape[0]
    if v % q:
        raise ValueError(f"vocabulary {v} does not split into {q} party "
                         "blocks")
    return table.view(q, v // q, *table.shape[1:])


def secure_vocab_embed(rt: Runtime, table: torch.Tensor,
                       tokens: torch.Tensor, gen: torch.Generator,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """tokens: integer (B, S); table: (V, D), party ℓ owning rows
    [ℓV/q, (ℓ+1)V/q).  Returns the (B, S, D) embeddings in ``out_dtype``;
    the masks are f32 and drawn from ``gen``."""
    q = rt.model_size
    blocks = party_blocks(table, q)
    v_loc = blocks.shape[1]
    lead = (q,) + (1,) * tokens.dim()
    party = torch.arange(q, device=tokens.device).view(lead)
    local = tokens.unsqueeze(0) - party * v_loc            # (q, B, S)
    owns = (local >= 0) & (local < v_loc)
    rows = blocks[party, local.clamp(0, v_loc - 1)]         # (q, B, S, D)
    partial = torch.where(owns.unsqueeze(-1), rows, 0.0).to(out_dtype)
    return secure_vfl_reduce(partial, gen, rt.mask_scale,
                             rt.schedule_faithful, rt.secure_mode)
