"""pixtral-12b [hf:mistralai/Pixtral-12B-2409] — mistral-nemo decoder
backbone; pixtral-ViT vision encoder stubbed (the inputs supply patch
embeddings, ``configs.inputs``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", arch_type="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336, vocab=131072,
    d_head=128, n_patches=1024, d_patch=1024, rope_theta=1_000_000.0,
    citation="hf:mistralai/Pixtral-12B-2409",
)
