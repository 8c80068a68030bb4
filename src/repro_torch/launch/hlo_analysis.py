"""Roofline terms and the analytic model counts (the port of
``repro.launch.hlo_analysis``).

The reference reads its terms from compiled XLA artifacts: FLOPs and
bytes from ``cost_analysis()``, and the collective bytes from the
post-partitioning HLO text, which it parses (``_shape_bytes``,
``_line_output_bytes``, ``collective_stats``).  No program of the port
produces HLO, so the parser is not ported: the port's counterpart of
"bytes crossing a boundary" is ``repro_torch.analysis.volume.step_volume``
(the party-boundary bytes of a ``make_fx`` trace), and ``launch.dryrun``
counts FLOPs with ``torch.utils.flop_counter`` and the kernels' own
tally.  On one card no step has a collective, so the reference's
``collective_s`` term and its ICI rate go too.

The hardware model is the card's data sheet, an H100 SXM 80GB HBM3 at
700 W, in place of the reference's TPU v5e figures: the dense bf16
tensor-core peak, the f32 peak outside the tensor cores, and the HBM
rate.  ``chip_smoke.py`` reads its bounds from these three names.

``model_flops``, ``param_count`` and ``active_param_count`` are the
reference's analytic counts, unchanged in arithmetic, over the port's
``layer_kinds``.  They count a feed-forward for every kind ending in
"mlp", so an encoder-decoder's count includes decoder feed-forwards that
neither package's ``init_params`` builds (ROADMAP C.R7, C.R9): whisper-tiny
counts 41,492,736 parameters where its tree holds 34,413,312.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor peak
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores


@dataclasses.dataclass
class Roofline:
    """One card's roofline of a step: ``flops`` (the step's FLOPs on the
    card), ``hbm_bytes`` (the bytes its operations read and write) and
    ``model_flops`` (the analytic useful FLOPs of the same tokens).  The
    compute term takes the bf16 tensor peak, as the reference's takes
    v5e's bf16 peak; the reference's ``n_chips`` is 1."""

    flops: float
    hbm_bytes: float
    model_flops: float

    @property
    def compute_s(self) -> float:
        return self.flops / BF16_FLOP_PER_S

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def bound_s(self) -> float:
        """The least time the step could take: the larger term."""
        return max(self.compute_s, self.memory_s)

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for
    inference (D = tokens processed).

    As the reference's, the prefill count charges the tied head
    (padded_vocab·d of N_active) at every prompt position, while
    ``models.model.prefill`` runs it at the last position only, so it
    exceeds what the step does by 2·padded_vocab·d·B·(S − 1).  A share of
    peak (MFU) of prefill should take this count less that term."""
    n_active = active_param_count(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def param_count(cfg) -> float:
    """Total parameters (analytic; ``init_params`` builds this many but
    for C.R9)."""
    return _count(cfg, active_only=False)


def active_param_count(cfg) -> float:
    """Parameters touched per token (MoE: top-k experts only)."""
    return _count(cfg, active_only=True)


def _count(cfg, active_only: bool) -> float:
    d = cfg.d_model
    emb = cfg.padded_vocab * d
    total = emb + d  # embed + final norm (tied head)
    from repro_torch.models.model import layer_kinds
    for kind in layer_kinds(cfg):
        total += d  # norm1
        if kind.startswith("attn"):
            dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv
            total += d * h * dh + 2 * d * hkv * dh + h * dh * d
        else:
            s = cfg.ssm
            ci = s.expand * d
            dt_rank = max(1, -(-d // 16))
            total += (d * 2 * ci + s.d_conv * ci + ci
                      + ci * (dt_rank + 2 * s.d_state)
                      + dt_rank * ci + ci + ci * s.d_state + ci + ci * d)
        if kind.endswith("mlp"):
            total += d + 3 * d * cfg.d_ff
        elif kind.endswith("moe"):
            e = cfg.moe.top_k if active_only else cfg.moe.n_experts
            total += d + cfg.d_model * cfg.moe.n_experts  # norm + router
            total += e * 3 * d * cfg.moe.d_expert
    if cfg.enc_dec:
        total += 2 * d * d  # enc_proj
        dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv
        per_enc = 2 * d + d * h * dh + 2 * d * hkv * dh + h * dh * d \
            + 3 * d * cfg.d_ff
        total += cfg.enc_layers * per_enc + d
        # decoder cross-attn
        total += cfg.n_layers * (d + d * h * dh + 2 * d * hkv * dh
                                 + h * dh * d)
    if cfg.arch_type == "vlm":
        total += cfg.d_patch * d
    return float(total)
