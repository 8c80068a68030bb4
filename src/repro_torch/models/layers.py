"""Shared building blocks of the LM stack (the port of
``repro.models.layers``, as far as the SSM family needs it).

Parameters are f32 (``PARAM_DTYPE``), activations bf16 (``ACT_DTYPE``);
norms and the SiLU gate compute their statistics and sigmoid in f32, as
the reference does.
"""
from __future__ import annotations

import torch

ACT_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def normal_init(gen: torch.Generator, shape, scale: float = 0.02,
                dtype=PARAM_DTYPE) -> torch.Tensor:
    """``scale`` × standard normals of ``shape``, drawn from ``gen`` on
    its device."""
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + scale), the statistics in f32,
    the result in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · σ(x): the sigmoid in f32, cast back, the product in x's
    dtype."""
    return x * torch.sigmoid(x.float()).to(x.dtype)
