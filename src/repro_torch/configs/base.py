"""Architecture and input-shape configuration (the port's copy of
``repro.configs.base``).

Every architecture is a frozen ``ArchConfig``, one module per architecture
under ``repro_torch.configs``.  ``reduced()`` gives the CPU smoke-test
variant (≤ 2 layers, or one 4-layer period, d_model ≤ 128, ≤ 4 experts)
of the same family.  Every id in ``ARCH_IDS`` has one: the SSM, dense,
MoE, hybrid (period stack), audio (encoder-decoder) and VLM families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attn-free
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 => d_model // n_heads
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # sliding-window pattern: window size + "every Nth layer is global"
    window: Optional[int] = None
    global_every: int = 0
    # hybrid (jamba): layer period description
    period: Optional[Tuple[str, ...]] = None
    # enc-dec (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0                 # stub frontend frames
    # vlm (pixtral)
    n_patches: int = 0
    d_patch: int = 0                 # stub ViT embedding dim
    rope_theta: float = 10000.0
    citation: str = ""
    # long-context capability (sub-quadratic decode path exists)
    supports_long: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, 256)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family."""
        kw = dataclasses.asdict(self)
        if self.moe is not None:
            kw["moe"] = MoESpec(n_experts=min(4, self.moe.n_experts),
                                top_k=min(2, self.moe.top_k),
                                d_expert=64, capacity_factor=1.25)
        if self.ssm is not None:
            kw["ssm"] = SSMSpec(d_state=8, d_conv=4, expand=2)
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv, max(1, n_heads // 2)) if self.n_kv else 0
        if self.period is not None:
            kw["period"] = ("ssm_mlp", "ssm_moe", "attn_mlp", "ssm_moe")
        kw.update(
            name=self.name + "-smoke",
            n_layers=2 if self.period is None else 4,
            d_model=d_model,
            n_heads=n_heads,
            n_kv=n_kv,
            d_head=(d_model // n_heads if n_heads else 0),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 32),
            n_patches=min(self.n_patches, 8),
            d_patch=min(self.d_patch, 64),
            window=(min(self.window, 16) if self.window else None),
        )
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode


ARCH_IDS = [
    "granite_moe_1b_a400m",
    "internlm2_20b",
    "whisper_tiny",
    "granite_8b",
    "gemma3_4b",
    "qwen3_moe_30b_a3b",
    "jamba_v0_1_52b",
    "stablelm_1_6b",
    "pixtral_12b",
    "falcon_mamba_7b",
]


# the paper's own linear workload, a config beside the LM architectures
LINEAR_IDS = ["paper_logreg"]


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS + LINEAR_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; known: "
                         f"{ARCH_IDS + LINEAR_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
