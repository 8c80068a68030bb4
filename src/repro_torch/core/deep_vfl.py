"""Deep (nonlinear) VFB²: party-local encoders + secure fused head.

The port of the parameter set and the plain forward of
``repro.core.deep_vfl`` (the sequential training oracle comes with the
deep training slice).  Each party ℓ encodes its block with a private
two-layer encoder h_ℓ = tanh(x_ℓ W1_ℓ + b1_ℓ) W2_ℓ; the representations
are aggregated through Algorithm 1 and the active parties' head maps the
sum to a logit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import PartyLayout


@dataclasses.dataclass
class DeepVFLParams:
    enc_w1: List[torch.Tensor]   # per party: (d_ℓ, hidden)
    enc_b1: List[torch.Tensor]   # per party: (hidden,)
    enc_w2: List[torch.Tensor]   # per party: (hidden, d_rep)
    head: torch.Tensor           # (d_rep,) — active parties' model


def init_deep_vfl(gen: torch.Generator, layout: PartyLayout, d: int,
                  hidden: int = 32, d_rep: int = 16) -> DeepVFLParams:
    """Random encoders with the reference's scales (W1 ~ 2/√d_ℓ·N(0, 1),
    W2 ~ N(0, 1)/√hidden, b1 = 0, head ~ N(0, 1)/√d_rep), drawn from
    ``gen`` on the generator's device.  ``d`` is the feature width the
    layout splits (kept for the reference's signature)."""
    if layout.bounds[-1][1] != d:
        raise ValueError(f"layout covers {layout.bounds[-1][1]} features, "
                         f"d={d}")
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    enc_w1, enc_b1, enc_w2 = [], [], []
    for lo, hi in layout.bounds:
        d_p = hi - lo
        enc_w1.append(normal(d_p, hidden) * (2.0 / np.sqrt(d_p)))
        enc_b1.append(torch.zeros((hidden,), device=dev))
        enc_w2.append(normal(hidden, d_rep) / np.sqrt(hidden))
    head = normal(d_rep) / np.sqrt(d_rep)
    return DeepVFLParams(enc_w1, enc_b1, enc_w2, head)


def _party_encode(w1, b1, w2, x_block):
    h = torch.tanh(x_block @ w1 + b1)
    return h @ w2                                     # (B, d_rep)


def fused_forward(params: DeepVFLParams, x_blocks,
                  gen: Optional[torch.Generator] = None,
                  mask_scale: float = 1.0):
    """Securely aggregated representation z = Σ_ℓ h_ℓ and logit.

    With ``gen`` given, executes the masked aggregation numerically (masks
    drawn per party; cancellation is exact to fp) — the secure and plain
    paths agree to float tolerance.
    """
    parts = [_party_encode(w1, b1, w2, xb) for w1, b1, w2, xb in
             zip(params.enc_w1, params.enc_b1, params.enc_w2, x_blocks)]
    if gen is not None:
        deltas = [mask_scale * torch.randn(p.shape, generator=gen,
                                           device=p.device,
                                           dtype=torch.float32)
                  for p in parts]
        xi1 = sum(p + d for p, d in zip(parts, deltas))
        xi2 = sum(deltas)
        z = xi1 - xi2
    else:
        z = sum(parts)
    logit = z @ params.head
    return z, logit
