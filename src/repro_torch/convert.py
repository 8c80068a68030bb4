"""Carry parameters across from the JAX package to the port.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of its
arrays, done by the caller, so this module never imports JAX):

* a linear iterate, ``(d,)`` or party-stacked ``(q, dp)``;
* deep parameters, as an object with the ``DeepVFLParams`` fields
  (``enc_w1``, ``enc_b1``, ``enc_w2``, ``head``) holding arrays, or the
  packed 4-tuple ``(w1q, b1q, w2q, headq)``.

Both keep their layout: the port packs and stacks exactly as the
reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.deep_vfl import DeepVFLParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def linear_iterate(w, *, device="cuda") -> torch.Tensor:
    """A ``(d,)`` or ``(q, dp)`` iterate as an f32 tensor on ``device``."""
    w = np.asarray(w, np.float32)
    if w.ndim not in (1, 2):
        raise ValueError(f"linear iterate must be (d,) or (q, dp), got "
                         f"{w.shape}")
    return _tensor(w, resolve_device(device))


def deep_params(params, *, device="cuda"):
    """Deep parameters on ``device``: a ``DeepVFLParams``-shaped object
    becomes the port's ``DeepVFLParams``; a packed 4-tuple stays a
    4-tuple of tensors."""
    dev = resolve_device(device)
    if isinstance(params, (tuple, list)):
        if len(params) != 4:
            raise ValueError("packed deep params are the 4-tuple "
                             "(w1q, b1q, w2q, headq)")
        return tuple(_tensor(a, dev) for a in params)
    return DeepVFLParams([_tensor(a, dev) for a in params.enc_w1],
                         [_tensor(a, dev) for a in params.enc_b1],
                         [_tensor(a, dev) for a in params.enc_w2],
                         _tensor(params.head, dev))
