"""Secure VFL frontends of the LM stack (the port of ``repro.vfl.embed``).

``secure_vocab_embed``: the raw input feature space of a token model is
the vocabulary one-hot space, and each party owns a disjoint block of the
embedding table's rows.  A lookup is each party's partial (its row where
it owns the token, zeros otherwise).

``secure_feature_project``: the continuous-modality form (whisper's audio
frames, pixtral's image patches).  The raw feature dimension is split
vertically over the parties; each projects its own feature block with its
private block of the weight's rows, the paper's Σ_ℓ w_{G_ℓ}ᵀ(x_i)_{G_ℓ}.

In both the result is the partials' masked sum (Algorithm 1) with the BUM
backward (``core.bum.secure_vfl_reduce``): every party receives ϑ =
∂L/∂(output) and forms its own block's gradient.  The q parties are the
leading dimension of the partial.
"""
from __future__ import annotations

import torch

from repro_torch.core.bum import secure_vfl_reduce
from repro_torch.sharding.api import Runtime


def party_blocks(table: torch.Tensor, q: int) -> torch.Tensor:
    """The (V, D) table (or a (d_in, D) projection) viewed as q row blocks
    (q, V/q, D)."""
    v = table.shape[0]
    if v % q:
        raise ValueError(f"{v} rows (vocabulary or features) do not split "
                         f"into {q} party blocks")
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


def secure_feature_project(rt: Runtime, w: torch.Tensor,
                           feats: torch.Tensor, gen: torch.Generator,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """feats: (B, S, d_in), party ℓ owning feature columns [ℓd_in/q,
    (ℓ+1)d_in/q); w: (d_in, D), party ℓ owning the same rows.  Each
    party's partial is its block's product in ``out_dtype``; returns their
    masked sum (B, S, D) in ``out_dtype``, the masks f32 and drawn from
    ``gen``."""
    q = rt.model_size
    d_in = feats.shape[-1]
    if w.dim() != 2 or w.shape[0] != d_in:
        raise ValueError(f"w must be (d_in, D) with d_in = {d_in}; got "
                         f"{tuple(w.shape)}")
    blocks = party_blocks(w, q)                              # (q, d_in/q, D)
    f = feats.unflatten(-1, (q, d_in // q)).movedim(-2, 0)   # (q, B, S, ·)
    partial = torch.matmul(f.to(out_dtype),
                           blocks.to(out_dtype).unsqueeze(1))
    return secure_vfl_reduce(partial, gen, rt.mask_scale,
                             rt.schedule_faithful, rt.secure_mode)
