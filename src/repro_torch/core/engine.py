"""The fused VFB² engine on PyTorch: serving's forward and aggregation, and
the linear training epochs.

The port of ``repro.core.engine``: the configuration, the vertical packing
helpers and the linear, single-dominator parts of ``FusedEngine`` — the
X-block contractions (``_fwd`` and ``_bwd``, the vfl_grad kernel's
forward and backward modes), the masked secure aggregation over the party
axis (``_agg``, Algorithm 1), the SGD / SVRG / SAGA epochs with their
full-dataset passes (``full_gradient``, ``saga_init``) and the objective.

Party axis: the q parties are the leading dimension of every
party-stacked tensor on one device (``xs`` is (q, n, dp), an iterate
(q, dp)), which is the single-device emulation the JAX engine runs under
``vmap``.  A party program written for one party in the reference is
written here once for all parties at once: a contraction takes the party
dimension into the kernel's launch, and the aggregation reduces over it.

Epochs.  The reference runs an epoch as one compiled program with no host
sync inside.  Here an epoch takes an explicit ``(steps, batch)`` int64
schedule ``idx`` (the reference draws it from its key inside the
program; see ``core.algorithms.epoch_indices``) and a ``mask_key`` tuple
of ints that seeds the epoch's mask stream.  On the card its step runs
once eagerly, is captured once as a CUDA graph per (epoch kind, schedule
shape) and is replayed for the remaining steps: the step reads its row of
``idx`` through a device counter that the graph increments, the learning
rate from a device scalar, and its masks from one generator registered
with the graph, so a replay draws fresh masks and no host sync happens
inside the epoch.  A graph launches its kernels without calling back into
Python, so the engine adds each replay's launches to the kernel's
counters itself.  On the CPU the same step runs eagerly ``steps`` times.

Device rule: ``FusedEngine`` defaults to ``device="cuda"`` and raises
without a card; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithms import PartyLayout, last_occurrence
from repro_torch.core.deep_vfl import DeepVFLParams
from repro_torch.core.losses import Problem
from repro_torch.core.secure_agg import (secure_psum, secure_psum_ring,
                                         seed_generator)
from repro_torch.kernels import ops
from repro_torch.kernels import vfl_grad as _vg

# mask-stream tags, one per entry point (the reference's fold_in constants)
_TAG_STEPS, _TAG_FULL, _TAG_SAGA_INIT = 0x5EC, 0xF, 0xA


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static knobs of the fused engine.

    Every X-block contraction goes through ``kernels.ops.vfl_grad``: the
    CUDA kernel on the card, its plain version on the CPU, for minibatch
    steps and full-dataset passes alike.  The reference's ``use_kernel``
    and ``kernel_max_rows`` choose between its Pallas kernel and XLA; here
    the other route would be cuBLAS, which is not the port, so they have
    no counterpart.  The reference's ``axis``, ``interpret``, ``block_b``,
    ``block_d`` and ``donate`` have no meaning here either: the party axis
    is a tensor dimension, the kernel is compiled (never interpreted) and
    picks its own tiling, and the epochs update their buffers in place.
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


def pack_mask(layout: PartyLayout, active_only: bool = False,
              device="cpu") -> torch.Tensor:
    """(q, dp) update mask: layout's trainable blocks minus the padding."""
    d = layout.bounds[-1][1]
    return pack_vec(layout.update_mask(d, active_only), layout, device)


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

class _StepLoop:
    """The static buffers of one epoch kind at one schedule shape — the
    carried state, the schedule ``idx``, the step counter ``t`` and the
    learning rate ``lr`` — and, on the card, the step's CUDA graph and the
    kernel launches one replay makes."""

    def __init__(self, bufs):
        self.bufs = bufs
        self.graph = None
        self.per_step = None


class FusedEngine:
    """Holds the packed vertical data and the security configuration, and
    runs the kernel-backed contractions, the masked aggregation and the
    linear epochs.

    Iterates are **party-stacked**: a linear iterate ``wq`` is (q, dp);
    use :meth:`pack_w`/:meth:`unpack_w` at the boundary.  SAGA's state is
    ``tabq`` (q, n), every party's copy of the ϑ̃ table, and ``avgq``
    (q, dp), as in the reference.  ``active_only=True`` freezes the
    passive parties' blocks (AFSVRG-VP).
    """

    def __init__(self, problem: Problem, x, y, layout: PartyLayout,
                 cfg: EngineConfig = EngineConfig(), *,
                 active_only: bool = False, device="cuda"):
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
        self.maskq = pack_mask(layout, active_only, self.device)
        # party p's sample i is row p*n + i of xs viewed as (q*n, dp)
        self._row0 = torch.arange(self.q, device=self.device)[:, None] \
            * self.n
        # every epoch's masks: one generator, re-seeded per call, which the
        # step graphs register so that each replay draws fresh masks
        self._gen = torch.Generator(device=self.device)
        self._loops = {}

    # -- X-block contractions (the vfl_grad kernel) ---------------------------

    def _fwd(self, xb, wcols):
        """(B, dp) @ (dp, M) -> (B, M) forward partial products; with a
        leading party axis, (q, B, dp) @ (q, dp, M) -> (q, B, M) in one
        kernel launch.  A rank-1 ``wcols`` gives a rank-1 result."""
        return ops.vfl_grad(xb, wcols, None, mode="forward")[0]

    def _bwd(self, xb, thq, denom: int):
        """BUM data gradients XᵀΘ/denom of every party in one kernel
        launch (``w=None``; the caller adds the regularizer): xb
        (q, B, dp) with the party-stacked Θ (q, B) or (q, B, M) -> (q, dp)
        or (q, dp, M).  A Θ shared by every party comes as
        :meth:`_share`'s view, which the kernel reads without copies."""
        return ops.vfl_grad(xb, None, thq, mode="backward", denom=denom)[1]

    def _share(self, theta):
        """The dominator's ϑ (B,) or (B, M), broadcast to every party: a
        party-stride-0 view, the stand-in for sending it to each party."""
        return theta.expand(self.q, *theta.shape)

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

    # -- running an epoch ----------------------------------------------------

    def _loop(self, name, idx, lr, mask_key, **carries) -> _StepLoop:
        """The step loop of epoch kind ``name`` at ``idx``'s shape, loaded
        with ``carries``, the schedule and ``lr``, its counter at 0, and
        the mask generator seeded from ``mask_key``."""
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        carries = {k: torch.as_tensor(v, dtype=torch.float32,
                                      device=self.device)
                   for k, v in carries.items()}
        if idx.dim() != 2:
            raise ValueError(f"idx must be (steps, batch); got "
                             f"{tuple(idx.shape)}")
        key = (name, tuple(idx.shape))
        loop = self._loops.get(key)
        if loop is None:
            bufs = {k: torch.empty_like(v) for k, v in carries.items()}
            bufs["idx"] = torch.empty_like(idx)
            bufs["t"] = torch.zeros((1,), dtype=torch.int64,
                                    device=self.device)
            bufs["lr"] = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
            loop = self._loops[key] = _StepLoop(bufs)
        b = loop.bufs
        for k, v in carries.items():
            b[k].copy_(v)
        b["idx"].copy_(idx)
        b["t"].zero_()
        b["lr"].fill_(float(lr))
        seed_generator(self._gen, *mask_key, _TAG_STEPS)
        return loop

    def _run(self, loop: _StepLoop, step) -> None:
        """Run ``step(loop.bufs)`` once per row of the schedule: eagerly on
        the CPU; on the card the first step eagerly (it also builds what
        is made at first use: the kernel library, the trees' round
        indices), then replays of the step's CUDA graph, captured at the
        first epoch of this kind and shape."""
        steps = loop.bufs["idx"].shape[0]
        if self.device.type != "cuda":
            for _ in range(steps):
                step(loop.bufs)
            return
        if steps == 0:
            return
        step(loop.bufs)
        if steps == 1:
            return
        if loop.graph is None:
            loop.graph, loop.per_step = self._capture(
                lambda: step(loop.bufs))
        for _ in range(steps - 1):
            loop.graph.replay()
        _vg.KERNEL.add_launches(loop.per_step, steps - 1)

    def _capture(self, fn):
        """Capture ``fn``'s launches as a CUDA graph on a side stream
        (nothing runs); returns the graph and the kernel launches per
        replay.  The counters went up while ``fn`` was recorded and are
        set back: the graph's replays are counted as they are made."""
        before = dict(_vg.KERNEL.launches)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                fn()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        per_step = {k: v - before[k]
                    for k, v in _vg.KERNEL.launches.items()}
        _vg.KERNEL.add_launches(per_step, -1)
        return graph, per_step

    def _batch(self, b):
        """This step's minibatch: the row of the schedule at the device
        counter (which moves on), its party-stacked feature block
        (q, B, dp) and its labels."""
        ib = b["idx"].index_select(0, b["t"]).squeeze(0)
        b["t"].add_(1)
        # one gather of q*B whole rows: xs.index_select(1, ib) would run as
        # an elementwise gather, several times slower on the card (PERF.md)
        rows = (self._row0 + ib).view(-1)
        xb = self.xs.view(-1, self.dp).index_select(0, rows) \
            .view(self.q, -1, self.dp)
        return ib, xb, self.y.index_select(0, ib)

    # -- SGD (Algorithms 2/3) ------------------------------------------------

    def _sgd_step(self, b):
        prob, wq = self.problem, b["wq"]
        ib, xb, yb = self._batch(b)
        z = self._fwd(xb, wq)                                     # (q, B)
        theta = prob.theta(self._agg(z, self._gen), yb)
        g = self._bwd(xb, self._share(theta), ib.shape[0]) \
            + prob.lam * prob.reg_grad(wq)
        wq.sub_(b["lr"] * self.maskq * g)

    def sgd_epoch(self, wq, lr, idx, mask_key=(0,)):
        """One VFB²-SGD epoch over the schedule ``idx`` (steps, batch);
        returns the new (q, dp) iterate."""
        loop = self._loop("sgd", idx, lr, mask_key, wq=wq)
        self._run(loop, self._sgd_step)
        return loop.bufs["wq"].clone()

    # -- SVRG (Algorithms 4/5): rank-2 steps ----------------------------------

    def full_gradient(self, wq, mask_key=(0,)):
        """∇f(w) of every party's block, (q, dp): one masked aggregation
        and one backward pass over all n samples."""
        prob = self.problem
        gen = seed_generator(self._gen, *mask_key, _TAG_FULL)
        z = self._fwd(self.xs, wq)                                # (q, n)
        theta = prob.theta(self._agg(z, gen), self.y)
        return self._bwd(self.xs, self._share(theta), self.n) \
            + prob.lam * prob.reg_grad(wq)

    def _svrg_step(self, b):
        prob, wq, wsq = self.problem, b["wq"], b["wsq"]
        ib, xb, yb = self._batch(b)
        z = self._fwd(xb, torch.stack([wq, wsq], dim=2))       # (q, B, 2)
        th = prob.theta(self._agg(z, self._gen), yb[:, None])    # (B, 2)
        gg = self._bwd(xb, self._share(th), ib.shape[0])        # (q, dp, 2)
        g1 = gg[..., 0] + prob.lam * prob.reg_grad(wq)
        g0 = gg[..., 1] + prob.lam * prob.reg_grad(wsq)
        wq.sub_(b["lr"] * self.maskq * (g1 - g0 + b["muq"]))

    def svrg_epoch(self, wq, wq_snap, muq, lr, idx, mask_key=(0,)):
        """Inner loop of VFB²-SVRG; the current iterate and the snapshot
        ride the same kernel launches (M = 2)."""
        loop = self._loop("svrg", idx, lr, mask_key, wq=wq, wsq=wq_snap,
                          muq=muq)
        self._run(loop, self._svrg_step)
        return loop.bufs["wq"].clone()

    # -- SAGA (Algorithms 6/7) -----------------------------------------------

    def saga_init(self, wq, mask_key=(0,)):
        """ϑ̃ table (q, n) + per-party running average (q, dp): Alg. 6
        step 2's pass over all n samples."""
        prob = self.problem
        gen = seed_generator(self._gen, *mask_key, _TAG_SAGA_INIT)
        z = self._fwd(self.xs, wq)
        theta = prob.theta(self._agg(z, gen), self.y)
        avgq = self._bwd(self.xs, self._share(theta), self.n)
        return theta.repeat(self.q, 1), avgq

    def _saga_step(self, b):
        prob, wq, tab, avg = self.problem, b["wq"], b["tabq"], b["avgq"]
        ib, xb, yb = self._batch(b)
        z = self._fwd(xb, wq)
        th_new = prob.theta(self._agg(z, self._gen), yb)          # (B,)
        # each party reads its own copy of the table: a per-party Θ
        raw = self._bwd(xb, th_new - tab.index_select(1, ib), 1)  # (q, dp)
        v = raw / ib.shape[0] + avg + prob.lam * prob.reg_grad(wq)
        wq.sub_(b["lr"] * self.maskq * v)
        avg.add_(raw / self.n)
        tab[:, ib] = th_new[last_occurrence(ib)]

    def saga_epoch(self, wq, tabq, avgq, lr, idx, mask_key=(0,)):
        """One VFB²-SAGA epoch; returns (wq, tabq, avgq).  On duplicate
        indices in a minibatch the last write to the table wins."""
        loop = self._loop("saga", idx, lr, mask_key, wq=wq, tabq=tabq,
                          avgq=avgq)
        self._run(loop, self._saga_step)
        b = loop.bufs
        return b["wq"].clone(), b["tabq"].clone(), b["avgq"].clone()

    def objective(self, wq) -> float:
        """Full objective (one device sync; for per-epoch telemetry).

        The padded coordinates are zero and every shipped regularizer maps
        0 → 0, so summing ``reg`` over the padded stack is exact."""
        prob = self.problem
        agg = self._fwd(self.xs, wq).sum(0)
        return float(torch.mean(prob.loss(agg, self.y))
                     + prob.lam * torch.sum(prob.reg(wq)))

    # -- boundary helpers ----------------------------------------------------

    def pack_w(self, w) -> torch.Tensor:
        return pack_vec(w, self.layout, self.device)

    def unpack_w(self, wq) -> np.ndarray:
        return unpack_vec(wq, self.layout)

    def pack_deep(self, params: DeepVFLParams):
        return pack_deep_params(params, self.layout, self.device)

    def unpack_deep(self, pq) -> DeepVFLParams:
        return unpack_deep_params(pq, self.layout)
