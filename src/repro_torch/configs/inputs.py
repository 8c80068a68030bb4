"""Concrete model inputs (the port of ``repro.configs.inputs``'
``token_split`` and ``make_batch``).

Every value is drawn with the reference's own ``np.random.default_rng(seed)``
calls, in its order (the tokens, the labels of a "train" batch, an
encoder-decoder's frames, a VLM's patches), so both packages get the same
inputs for the same seed, bit for bit.  Tokens are int64 tensors (the
reference's are int32); frames and patches are bf16, as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model import init_cache
from repro_torch.sharding.api import Runtime


def token_split(cfg: ArchConfig, seq_len: int) -> int:
    """The text-token count of a ``seq_len``-position sequence: a VLM's
    patches take a prefix of ``n_patches`` positions."""
    if cfg.arch_type == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def _bf16(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """float64 draws rounded to bf16 on the host, as the reference's
    ``jnp.asarray(a, jnp.bfloat16)`` rounds them."""
    return torch.as_tensor(a).to(torch.bfloat16).to(dev)


def make_batch(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime,
               seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """A random batch for ``shape.mode`` "train" ({"tokens", "labels"},
    each (B, S_text)), "prefill" ({"tokens": (B, S_text)}) or "decode"
    ({"token": (B,), "pos": S // 2, "cache": zeros}).  S_text is
    ``token_split(cfg, S)``; an encoder-decoder's "train" and "prefill"
    batches add "frames" (B, enc_seq, 2·d_model), a VLM's "patches" (B,
    n_patches, d_patch)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        s_text = token_split(cfg, s)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (b, s_text)), device=dev)}
        if shape.mode == "train":
            batch["labels"] = torch.as_tensor(
                rng.integers(0, cfg.vocab, (b, s_text)), device=dev)
        if cfg.enc_dec:
            batch["frames"] = _bf16(rng.standard_normal(
                (b, cfg.enc_seq, 2 * cfg.d_model)), dev)
        if cfg.arch_type == "vlm":
            batch["patches"] = _bf16(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_patch)), dev)
        return batch
    if shape.mode == "decode":
        cache = init_cache(rt, cfg, b, s, device=dev)
        return {"token": torch.as_tensor(rng.integers(0, cfg.vocab, (b,)),
                                         device=dev),
                "pos": s // 2, "cache": cache}
    raise ValueError(f"mode must be 'train', 'prefill' or 'decode'; got "
                     f"{shape.mode!r}")
