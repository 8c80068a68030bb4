"""falcon-mamba-7b [arXiv:2410.05355] — attention-free mamba1."""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_ff=0, vocab=65024,
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2), supports_long=True,
    citation="arXiv:2410.05355",
)
