"""granite-8b [arXiv:2405.04324] — llama-arch dense, code."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", arch_type="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=49152,
    d_head=128, citation="arXiv:2405.04324",
)
