"""Concrete model inputs (the port of ``repro.configs.inputs.make_batch``).

The tokens are drawn with the reference's own ``np.random.default_rng(seed)``
calls, in its order (a "train" batch: the tokens, then the labels), so
both packages get the same tokens for the same seed.  Tokens are int64
tensors (the reference's are int32).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model import init_cache
from repro_torch.sharding.api import Runtime


def make_batch(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime,
               seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """A random batch for ``shape.mode`` "train" ({"tokens", "labels"},
    each (B, S)), "prefill" ({"tokens": (B, S)}) or "decode" ({"token":
    (B,), "pos": S // 2, "cache": zeros})."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (b, s)), device=dev)}
        if shape.mode == "train":
            batch["labels"] = torch.as_tensor(
                rng.integers(0, cfg.vocab, (b, s)), device=dev)
        return batch
    if shape.mode == "decode":
        cache = init_cache(rt, cfg, b, s, device=dev)
        return {"token": torch.as_tensor(rng.integers(0, cfg.vocab, (b,)),
                                         device=dev),
                "pos": s // 2, "cache": cache}
    raise ValueError(f"mode must be 'train', 'prefill' or 'decode'; got "
                     f"{shape.mode!r}")
