"""The paper's own workload: regularized (logistic) regression over
vertically partitioned features (problems 13/14/17/18).  It runs on the
linear engine (``core``), not the LM stack: the config names it
beside the architectures."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paper-logreg", arch_type="linear",
    n_layers=0, d_model=0, n_heads=0, n_kv=0, d_ff=0, vocab=0,
    citation="this paper (AAAI'21, VFB^2)",
)
