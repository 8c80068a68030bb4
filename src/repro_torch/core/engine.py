"""The fused VFB² engine on PyTorch — the serving subset.

The port of ``repro.core.engine``: the configuration, the vertical packing
helpers and the parts of ``FusedEngine`` that serving runs — the X-block
forward contraction (``_fwd``, the vfl_grad kernel) and the masked secure
aggregation over the party axis (``_agg``, Algorithm 1).  The epochs come
with the training slice.

Party axis: the q parties are the leading dimension of every
party-stacked tensor on one device (``xs`` is (q, n, dp), an iterate
(q, dp)), which is the single-device emulation the JAX engine runs under
``vmap``.  A party program written for one party in the reference is
written here once for all parties at once: a contraction takes the party
dimension into the kernel's launch, and the aggregation reduces over it.

Device rule: ``FusedEngine`` defaults to ``device="cuda"`` and raises
without a card; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import PartyLayout
from repro_torch.core.deep_vfl import DeepVFLParams
from repro_torch.core.losses import Problem
from repro_torch.core.secure_agg import secure_psum, secure_psum_ring
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static knobs of the fused engine.

    Every X-block contraction goes through ``kernels.ops.vfl_grad``: the
    CUDA kernel on the card, its plain version on the CPU.  The
    reference's ``use_kernel`` and ``kernel_max_rows`` choose between its
    Pallas kernel and XLA; here the other route would be cuBLAS, which is
    not the port, so they wait for the training slice's full-dataset
    passes.  The reference's ``axis``, ``interpret``, ``block_b``,
    ``block_d`` and ``donate`` have no meaning here either: the party axis
    is a tensor dimension, the kernel is compiled (never interpreted) and
    picks its own tiling, and PyTorch updates buffers in place without
    donation.
    """

    secure: str = "off"              # "off" | "two_tree" | "ring"
    mask_scale: float = 1.0
    schedule_faithful: bool = False  # replay exact T1/T2 rounds


# ---------------------------------------------------------------------------
# vertical packing: (n, d) features -> (q, n, dp) padded party blocks
# ---------------------------------------------------------------------------

def party_widths(layout: PartyLayout) -> np.ndarray:
    return np.asarray([hi - lo for lo, hi in layout.bounds], np.int64)


def pack_features(x, layout: PartyLayout, device) -> torch.Tensor:
    """Stack per-party feature blocks, zero-padded to the widest block.

    ``x`` is an (n, d) numpy array or tensor; a tensor already on
    ``device`` is packed there without a host copy."""
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    n = xt.shape[0]
    dp = int(party_widths(layout).max())
    xs = torch.zeros((layout.q, n, dp), dtype=torch.float32, device=device)
    for p, (lo, hi) in enumerate(layout.bounds):
        xs[p, :, : hi - lo] = xt[:, lo:hi]
    return xs


def pack_vec(v, layout: PartyLayout, device) -> torch.Tensor:
    """(d,) coordinate vector -> (q, dp) party-stacked, zero-padded."""
    vt = torch.as_tensor(v, dtype=torch.float32, device=device)
    dp = int(party_widths(layout).max())
    out = torch.zeros((layout.q, dp), dtype=torch.float32, device=device)
    for p, (lo, hi) in enumerate(layout.bounds):
        out[p, : hi - lo] = vt[lo:hi]
    return out


def unpack_vec(vq, layout: PartyLayout) -> np.ndarray:
    """(q, dp) party-stacked -> (d,) coordinate vector (drops padding)."""
    vq = torch.as_tensor(vq).detach().cpu().numpy()
    return np.concatenate([vq[p, : hi - lo]
                           for p, (lo, hi) in enumerate(layout.bounds)])


def pack_deep_params(params: DeepVFLParams, layout: PartyLayout, device):
    """``DeepVFLParams`` -> party-stacked ``(w1q, b1q, w2q, headq)``.

    ``w1q`` (q, dp, hidden) zero-pads each party's first encoder layer to
    the widest feature block; ``headq`` (q, d_rep) replicates the active
    parties' head (the stand-in for the dominator broadcasting ϑ_z)."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    dp = int(party_widths(layout).max())
    hidden = int(params.enc_w1[0].shape[1])
    w1q = torch.zeros((layout.q, dp, hidden), dtype=torch.float32,
                      device=device)
    for p, (lo, hi) in enumerate(layout.bounds):
        w1q[p, : hi - lo] = f32(params.enc_w1[p])
    b1q = torch.stack([f32(b) for b in params.enc_b1])
    w2q = torch.stack([f32(w) for w in params.enc_w2])
    headq = f32(params.head)[None, :].repeat(layout.q, 1)
    return w1q, b1q, w2q, headq


def unpack_deep_params(pq, layout: PartyLayout) -> DeepVFLParams:
    """Party-stacked deep params -> ``DeepVFLParams`` (drops padding)."""
    w1q, b1q, w2q, headq = pq
    return DeepVFLParams([w1q[p, : hi - lo].clone()
                          for p, (lo, hi) in enumerate(layout.bounds)],
                         [b.clone() for b in b1q],
                         [w.clone() for w in w2q],
                         headq[0].clone())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class FusedEngine:
    """Holds the packed vertical data and the security configuration, and
    runs the kernel-backed contraction and the masked aggregation.

    Iterates are **party-stacked**: a linear iterate ``wq`` is (q, dp);
    use :meth:`pack_w`/:meth:`unpack_w` at the boundary.
    """

    def __init__(self, problem: Problem, x, y, layout: PartyLayout,
                 cfg: EngineConfig = EngineConfig(), *, device="cuda"):
        if cfg.secure not in ("off", "two_tree", "ring"):
            raise ValueError(f"unknown secure mode {cfg.secure!r} "
                             "(expected 'off', 'two_tree' or 'ring')")
        self.device = resolve_device(device)
        self.problem = problem
        self.layout = layout
        self.cfg = cfg
        self.q = layout.q
        self.xs = pack_features(x, layout, self.device)      # (q, n, dp)
        self.n = int(self.xs.shape[1])
        self.dp = int(self.xs.shape[2])
        self.y = torch.as_tensor(y, dtype=torch.float32, device=self.device)

    # -- X-block contractions (the vfl_grad kernel) ---------------------------

    def _fwd(self, xb, wcols):
        """(B, dp) @ (dp, M) -> (B, M) forward partial products; with a
        leading party axis, (q, B, dp) @ (q, dp, M) -> (q, B, M) in one
        kernel launch.  A rank-1 ``wcols`` gives a rank-1 result."""
        return ops.vfl_grad(xb, wcols, None, mode="forward")[0]

    def _agg(self, z, gen: torch.Generator):
        """Masked secure aggregation of the party-stacked partials z
        (q, ...) over the party axis -> the aggregate (...)."""
        cfg = self.cfg
        if cfg.secure == "off":
            return z.sum(0)
        if cfg.secure == "ring":
            return secure_psum_ring(z, gen, mask_scale=cfg.mask_scale)
        return secure_psum(z, gen, mask_scale=cfg.mask_scale,
                           schedule_faithful=cfg.schedule_faithful)

    # -- boundary helpers ----------------------------------------------------

    def pack_w(self, w) -> torch.Tensor:
        return pack_vec(w, self.layout, self.device)

    def unpack_w(self, wq) -> np.ndarray:
        return unpack_vec(wq, self.layout)

    def pack_deep(self, params: DeepVFLParams):
        return pack_deep_params(params, self.layout, self.device)

    def unpack_deep(self, pq) -> DeepVFLParams:
        return unpack_deep_params(pq, self.layout)
