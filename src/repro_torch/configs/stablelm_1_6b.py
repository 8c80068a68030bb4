"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] — dense MHA (kv=heads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", arch_type="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=5632, vocab=100352,
    d_head=64, citation="hf:stabilityai/stablelm-2-1_6b",
)
