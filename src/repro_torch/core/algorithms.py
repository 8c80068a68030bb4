"""The vertical feature split (``PartyLayout``).

A copy of ``repro.core.algorithms.PartyLayout`` (numpy only), kept here so
the port imports nothing of the JAX package.  The epoch oracles of that
module are ported with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartyLayout:
    """Vertical partition of d features over q parties; m active parties.

    Parties 0..m-1 are active (hold labels); m..q-1 are passive.
    """

    q: int
    m: int
    bounds: Tuple[Tuple[int, int], ...]  # (lo, hi) per party

    @staticmethod
    def even(d: int, q: int, m: int) -> "PartyLayout":
        if not 1 <= m <= q:
            raise ValueError(f"need 1 <= m <= q, got m={m}, q={q}")
        cuts = np.linspace(0, d, q + 1).astype(int)
        return PartyLayout(q=q, m=m,
                           bounds=tuple((int(cuts[i]), int(cuts[i + 1]))
                                        for i in range(q)))

    def update_mask(self, d: int, active_only: bool) -> np.ndarray:
        """1.0 where the coordinate may be updated.

        ``active_only=True`` reproduces AFSVRG-VP: only active-party blocks
        (those whose owners hold labels) are trainable.
        """
        mask = np.zeros(d, np.float32)
        parties = range(self.m) if active_only else range(self.q)
        for p in parties:
            lo, hi = self.bounds[p]
            mask[lo:hi] = 1.0
        return mask

    def party_of_coord(self, d: int) -> np.ndarray:
        owner = np.zeros(d, np.int32)
        for p, (lo, hi) in enumerate(self.bounds):
            owner[lo:hi] = p
        return owner
