"""gemma3-4b [hf:google/gemma-3-1b-pt] — 5:1 local:global sliding window,
128k context => sub-quadratic long-context capable."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", arch_type="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, d_ff=10240, vocab=262144,
    d_head=256, window=1024, global_every=6, supports_long=True,
    rope_theta=1_000_000.0, citation="hf:google/gemma-3-1b-pt",
)
