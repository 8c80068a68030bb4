"""jamba-v0.1-52b [arXiv:2403.19887] — Mamba+attention 1:7 interleave,
MoE 16 experts top-2 on every other layer; period of 8 layers with the
attention mixer at position 4 (Jamba paper Fig. 2)."""
from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec

# Jamba block = {mamba|attention} mixer + {MLP|MoE} FFN; attention mixer at
# period position 4, MoE on every other layer (Jamba paper Fig. 2).
PERIOD = ("ssm_mlp", "ssm_moe", "ssm_mlp", "ssm_moe",
          "attn_mlp", "ssm_moe", "ssm_mlp", "ssm_moe")

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=65536,
    d_head=128, moe=MoESpec(n_experts=16, top_k=2, d_expert=14336),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2),
    period=PERIOD, supports_long=True, citation="arXiv:2403.19887",
)
