"""Mamba-1 selective SSM block (the port of ``repro.models.ssm``).

Layout follows mamba-1: in-projection → (x, z); depthwise causal conv
(d_conv = 4) on x; data-dependent Δ, B, C; diagonal A; the selective scan

    h_t = exp(Δ_t A) ⊙ h_{t−1} + Δ_t B_t x_t ;  y_t = C_t·h_t + D x_t

and output = (y ⊙ silu(z)) @ W_out.  The dtypes and the order of
operations are the reference's: the conv taps are summed in tap order in
the activation dtype, Δ is a softplus in f32 of a bf16 product plus
``dt_bias``, B and C are bf16 values held as f32, and the decode step
keeps its conv state in bf16 and h in f32.

``apply_ssm`` runs the scan through ``ops.selective_scan``
(``scan_impl="kernel"``: the CUDA kernel on the card, the counterpart of
the reference's ``"pallas"``) or through the sequential oracle
(``"reference"``).  The one-token decode step is plain torch, as in the
reference, which has no kernel there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import normal_init, silu

# The sequential oracle: (y (B, S, Ci) in xa's dtype, h_final (B, Ci, N)
# f32), from h0 or zeros (``repro/models/ssm.py:78``).
selective_scan_ref = ref.selective_scan_state


def init_ssm(gen: torch.Generator, d_model: int, d_state: int = 16,
             d_conv: int = 4, expand: int = 2, *, lead=()):
    """One block's parameters, with ``lead`` prepended to every shape (a
    leading layer axis for a stacked model), drawn from ``gen`` on its
    device."""
    d_inner = expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    lead = tuple(lead)
    dev = gen.device
    u = torch.rand(lead + (d_inner,), generator=gen, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(u * (hi - lo) + lo).clamp(min=1e-4)
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": normal_init(gen, lead + (d_model, 2 * d_inner)),
        "conv_w": normal_init(gen, lead + (d_conv, d_inner), scale=0.5),
        "conv_b": torch.zeros(lead + (d_inner,), device=dev),
        "w_x_dbc": normal_init(gen, lead + (d_inner, dt_rank + 2 * d_state)),
        "w_dt": normal_init(gen, lead + (dt_rank, d_inner)),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "a_log": torch.log(a).expand(lead + (d_inner, d_state)).contiguous(),
        "d_skip": torch.ones(lead + (d_inner,), device=dev),
        "w_out": normal_init(gen, lead + (d_inner, d_model)),
    }


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence.  x (B, S, C); conv_w
    (K, C); ``state`` (B, K−1, C), the trailing context of earlier
    tokens (decode), or zeros.  Returns (y, new_state)."""
    k, s = conv_w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+K−1, C)
    y = sum(xp[:, i:i + s] * conv_w[i].to(x.dtype) for i in range(k))
    y = y + conv_b.to(x.dtype)
    return y, xp[:, -(k - 1):]


def _dbc(params, xa: torch.Tensor):
    """Data-dependent Δ (B, S, Ci) and B, C (B, S, N) from the activated
    conv output."""
    d_state = params["a_log"].shape[1]
    dt_rank = params["w_x_dbc"].shape[1] - 2 * d_state
    dbc = xa @ params["w_x_dbc"].to(xa.dtype)
    dt_low, b_ssm, c_ssm = dbc.split([dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus((dt_low @ params["w_dt"].to(xa.dtype)).float()
                    + params["dt_bias"])
    return dt, b_ssm.float(), c_ssm.float()


def apply_ssm(params, x: torch.Tensor, *,
              scan_impl: str = "kernel") -> torch.Tensor:
    """The full mamba block over a sequence (prefill).  x: (B, S, D)."""
    d_inner = params["a_log"].shape[0]
    xz = x @ params["w_in"].to(x.dtype)
    xc, z = xz.split([d_inner, d_inner], dim=-1)
    xc, _ = _causal_conv(xc, params["conv_w"], params["conv_b"])
    xa = silu(xc)
    dt, b_ssm, c_ssm = _dbc(params, xa)
    if scan_impl == "kernel":
        y = ops.selective_scan(xa, dt, b_ssm, c_ssm, params["a_log"],
                               params["d_skip"])
    elif scan_impl == "reference":
        y, _ = selective_scan_ref(xa, dt, b_ssm, c_ssm, params["a_log"],
                                  params["d_skip"])
    else:
        raise ValueError(f"scan_impl must be 'kernel' or 'reference'; got "
                         f"{scan_impl!r}")
    return (y * silu(z)) @ params["w_out"].to(x.dtype)


def init_ssm_cache(batch: int, d_model: int, d_state: int = 16,
                   d_conv: int = 4, expand: int = 2, *, lead=(),
                   device="cuda"):
    """Zero decode state: the conv context (B, K−1, Ci) bf16 and h
    (B, Ci, N) f32, with ``lead`` prepended (a leading layer axis)."""
    dev = resolve_device(device)
    d_inner = expand * d_model
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, d_conv - 1, d_inner),
                            dtype=torch.bfloat16, device=dev),
        "h": torch.zeros(lead + (batch, d_inner, d_state),
                         dtype=torch.float32, device=dev),
    }


def apply_ssm_decode(params, x: torch.Tensor, cache):
    """One-token step.  x: (B, D) → ((B, D), new cache)."""
    d_inner = params["a_log"].shape[0]
    xz = x @ params["w_in"].to(x.dtype)
    xc, z = xz.split([d_inner, d_inner], dim=-1)
    xc3, new_conv = _causal_conv(xc[:, None], params["conv_w"],
                                 params["conv_b"], state=cache["conv"])
    xa = silu(xc3)[:, 0]                                    # (B, Ci)
    dt, b_ssm, c_ssm = _dbc(params, xa[:, None])
    dt, b_ssm, c_ssm = dt[:, 0], b_ssm[:, 0], c_ssm[:, 0]
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt[..., None] * a[None])
    h = da * cache["h"] + (dt * xa.float())[..., None] * b_ssm[:, None, :]
    y = torch.einsum("bcn,bn->bc", h, c_ssm) \
        + params["d_skip"] * xa.float()
    out = (y.to(x.dtype) * silu(z)) @ params["w_out"].to(x.dtype)
    return out, {"conv": new_conv, "h": h}
