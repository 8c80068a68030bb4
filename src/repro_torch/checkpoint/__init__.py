"""Atomic, ring-retained checkpoints in the JAX package's bundle format."""
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
