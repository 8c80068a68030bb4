"""VFB² core on PyTorch: layout, losses, Algorithm 1, the fused engine."""
