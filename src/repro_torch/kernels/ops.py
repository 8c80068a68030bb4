"""Public wrappers for the port's kernels.

``vfl_grad`` keeps the signature of ``repro.kernels.ops.vfl_grad``.  The
tensors it is given decide where it runs: on CUDA tensors it launches the
hand-written CUDA kernel (``kernels.vfl_grad``) or raises; on CPU tensors
it runs the plain version (``kernels.ref``).  Nothing falls back from one
to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import vfl_grad as _vg

_DTYPES = (torch.float32, torch.bfloat16)


def vfl_grad(xb, w, theta=None, lam=0.0, *, mode="forward", denom=None,
             split=None):
    """Batched rank-k VFL kernel, forward mode: ``(z, None)`` with
    z = xb @ w accumulated in f32.

    Shapes: xb (B, D) with w (D,) or (D, M); or, with a leading party
    axis so that one launch serves all parties, xb (P, B, D) with w
    (P, D) or (P, D, M).  A rank-1 weight gives a rank-1 z per party, as
    in the reference.  xb and w share a dtype, float32 or bfloat16; z is
    float32.  ``theta``, ``lam`` and ``denom`` are accepted and unused in
    forward mode, as in the reference.

    ``mode="backward"``, ``mode="fused"`` and ``split=`` are not ported
    yet (ROADMAP queue B, item B1) and raise on every device.
    """
    if mode not in ("forward", "backward", "fused"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "forward" or split is not None:
        raise NotImplementedError(
            "vfl_grad: only mode='forward' is ported; the backward and "
            "fused modes and the split-batch form are ROADMAP item B1 (b)-(d)")
    del theta, lam, denom                      # forward mode reads neither
    if w is None:
        raise ValueError("mode='forward' needs w")
    if xb.dtype not in _DTYPES or w.dtype != xb.dtype:
        raise ValueError(f"xb and w must share a dtype in {_DTYPES}; got "
                         f"{xb.dtype}, {w.dtype}")
    if w.device != xb.device:
        raise ValueError(f"xb on {xb.device}, w on {w.device}")
    rank1 = w.dim() == xb.dim() - 1
    if xb.dim() == 2 and w.dim() in (1, 2):
        x3 = xb.unsqueeze(0)
        w3 = w.reshape(1, w.shape[0], 1 if rank1 else w.shape[1])
    elif xb.dim() == 3 and w.dim() in (2, 3) and w.shape[0] == xb.shape[0]:
        x3 = xb
        w3 = w.reshape(w.shape[0], w.shape[1], 1 if rank1 else w.shape[2])
    else:
        raise ValueError(f"bad shapes xb {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}: want (B, D) with (D,)/(D, M) "
                         "or (P, B, D) with (P, D)/(P, D, M)")
    if w3.shape[1] != x3.shape[2]:
        raise ValueError(f"contraction mismatch: xb {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}")
    if xb.device.type == "cpu":
        return ref.vfl_forward_ref(xb, w), None
    if xb.device.type != "cuda":
        raise ValueError(f"vfl_grad runs on cpu or cuda, not {xb.device}")
    z = _vg.KERNEL.forward(x3, w3)
    if rank1:
        z = z.squeeze(-1)
    return (z.squeeze(0) if xb.dim() == 2 else z), None
