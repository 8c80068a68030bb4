"""internlm2-20b [arXiv:2403.17297] — dense GQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", arch_type="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=92544,
    d_head=128, citation="arXiv:2403.17297",
)
