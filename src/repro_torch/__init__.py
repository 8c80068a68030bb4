"""VFB² on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors the JAX package's layout (``core/``, ``kernels/``,
``serve/``, and for the LM stack ``configs/``, ``models/``, ``vfl/``,
``sharding/``, ``launch/``) so each module's counterpart is found under
the same name.  It
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Party axis: the q parties are a leading tensor dimension on one device —
``vmap`` over the party axis becomes that dimension, ``psum`` a sum over
it, a ``ppermute`` round index arithmetic on it.

Device rule: every entry point (``FusedEngine``, ``ServeEngine``,
``launch.serve.serve``, ...) defaults to ``device="cuda"`` and raises
without a card; the CPU runs only when the caller passes ``device="cpu"``.
The wrappers in ``kernels.ops`` follow the tensors they are given: their
plain versions on CPU tensors, the CUDA kernels on CUDA tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev
