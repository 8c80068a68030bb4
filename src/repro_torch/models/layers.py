"""Shared building blocks of the LM stack (the port of
``repro.models.layers``, as far as the SSM, dense and MoE families need it).

Parameters are f32 (``PARAM_DTYPE``), activations bf16 (``ACT_DTYPE``);
norms, rotary angles and the SiLU gate compute in f32, as the reference
does, and weights are cast to the activations' dtype where they are used.
"""
from __future__ import annotations

import numpy as np
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


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    """The d_head/2 rotary frequencies θ^(−2i/d_head), in float64 as the
    reference computes them (cast to f32 where used)."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, split-half form.  x: (..., S, H, dh); positions:
    (..., S) integers.  Angles and the rotation in f32, the result in x's
    dtype."""
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    ang = positions.to(torch.float32)[..., None] * freqs    # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """(silu(x·W_gate) ⊙ x·W_up)·W_down, each f32 weight cast to x's
    dtype at use."""
    g = silu(x @ w_gate.to(x.dtype))
    u = x @ w_up.to(x.dtype)
    return (g * u) @ w_down.to(x.dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, lead=()):
    """SwiGLU weights with ``lead`` prepended (a leading layer axis),
    drawn from ``gen`` on its device."""
    lead = tuple(lead)
    return {"w_gate": normal_init(gen, lead + (d_model, d_ff)),
            "w_up": normal_init(gen, lead + (d_model, d_ff)),
            "w_down": normal_init(gen, lead + (d_ff, d_model))}


def apply_mlp(params, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
