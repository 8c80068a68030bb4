"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
    d_head=64, moe=MoESpec(n_experts=32, top_k=8, d_expert=512),
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
