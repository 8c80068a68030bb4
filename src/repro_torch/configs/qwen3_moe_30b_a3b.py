"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_ff=768, vocab=151936,
    d_head=128, moe=MoESpec(n_experts=128, top_k=8, d_expert=768),
    rope_theta=1_000_000.0, citation="hf:Qwen/Qwen3-30B-A3B",
)
