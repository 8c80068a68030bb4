"""The LM stack's runtime settings (the port of ``repro.sharding.api``'s
``Runtime``, the fields the SSM and dense serving paths read).

There is no mesh: the q parties are a leading tensor dimension on one
device, so ``model_size`` is q itself.  The decode KV cache's sequence
axis is sharded over the q parties, as the reference's
``cache_seq_axes=("model",)`` shards it: on one device the cache is
viewed as q shards of S/q positions, so no field is needed for it.
There is no ``use_runtime`` global either: every model function takes
its ``Runtime`` explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SECURE_MODES = ("two_tree", "ring_masks")
SCAN_IMPLS = ("kernel", "reference")
ATTN_IMPLS = ("kernel", "reference")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """``model_size``: the party count q (each party owns a V/q block of
    the vocabulary).  ``secure_embed``: embed through the parties'
    masked aggregation (else a plain table lookup).  ``mask_scale``,
    ``schedule_faithful`` and ``secure_mode`` configure that aggregation
    (``"two_tree"``: Algorithm 1; ``"ring_masks"``: pairwise-cancelling
    ring masks).  ``scan_impl``: ``"kernel"`` runs ``ops.selective_scan``
    (the CUDA kernel on the card; the counterpart of the reference's
    ``"pallas"``), ``"reference"`` the sequential oracle.  ``attn_impl``:
    ``"kernel"`` runs ``ops.flash_attention`` in the prefill and
    ``ops.decode_attention`` over all q cache shards in a decode step
    (the CUDA kernels on the card), ``"reference"`` the plain
    ``chunked_attention`` and ``local_decode_attention`` per shard.
    ``attn_chunk``: the query chunk of ``chunked_attention``.
    ``remat``, ``unroll_layers`` and ``seq_parallel_norms`` are the
    reference's training and mesh levers; none means anything to eager
    inference on one device, and setting one raises (ROADMAP A15)."""

    model_size: int = 1
    secure_embed: bool = True
    mask_scale: float = 1.0
    schedule_faithful: bool = False
    secure_mode: str = "two_tree"
    scan_impl: str = "kernel"
    attn_impl: str = "kernel"
    attn_chunk: int = 1024
    remat: bool = False
    unroll_layers: Optional[int] = None
    seq_parallel_norms: bool = False

    def __post_init__(self):
        if self.model_size < 1:
            raise ValueError(f"model_size must be >= 1; got "
                             f"{self.model_size}")
        if self.secure_mode not in SECURE_MODES:
            raise ValueError(f"secure_mode must be one of {SECURE_MODES}; "
                             f"got {self.secure_mode!r}")
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl must be one of {SCAN_IMPLS}; got "
                             f"{self.scan_impl!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}; got "
                             f"{self.attn_impl!r}")
        if self.attn_chunk < 1:
            raise ValueError(f"attn_chunk must be >= 1; got "
                             f"{self.attn_chunk}")
        if self.remat or self.unroll_layers is not None \
                or self.seq_parallel_norms:
            raise NotImplementedError(
                "remat, unroll_layers and seq_parallel_norms are not ported "
                "(the LM stack's training and mesh levers, ROADMAP A15)")
