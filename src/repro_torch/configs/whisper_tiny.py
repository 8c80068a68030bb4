"""whisper-tiny [arXiv:2212.04356] — enc-dec; conv/mel frontend stubbed
(the inputs supply precomputed frame embeddings, ``configs.inputs``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", arch_type="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    d_head=64, enc_dec=True, enc_layers=4, enc_seq=1500,
    citation="arXiv:2212.04356",
)
