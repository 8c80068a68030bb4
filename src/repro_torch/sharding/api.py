"""The LM stack's runtime settings (the port of ``repro.sharding.api``'s
``Runtime``, the fields the SSM serving path reads).

There is no mesh: the q parties are a leading tensor dimension on one
device, so ``model_size`` is q itself.  There is no ``use_runtime``
global either: every model function takes its ``Runtime`` explicitly.
"""
from __future__ import annotations

import dataclasses

SECURE_MODES = ("two_tree", "ring_masks")
SCAN_IMPLS = ("kernel", "reference")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """``model_size``: the party count q (each party owns a V/q block of
    the vocabulary).  ``secure_embed``: embed through the parties'
    masked aggregation (else a plain table lookup).  ``mask_scale``,
    ``schedule_faithful`` and ``secure_mode`` configure that aggregation
    (``"two_tree"``: Algorithm 1; ``"ring_masks"``: pairwise-cancelling
    ring masks).  ``scan_impl``: ``"kernel"`` runs ``ops.selective_scan``
    (the CUDA kernel on the card; the counterpart of the reference's
    ``"pallas"``), ``"reference"`` the sequential oracle."""

    model_size: int = 1
    secure_embed: bool = True
    mask_scale: float = 1.0
    schedule_faithful: bool = False
    secure_mode: str = "two_tree"
    scan_impl: str = "kernel"

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
