"""Vertical (feature-wise) partitioning utilities (a copy of
``repro.data.vertical`` over the port's ``PartyLayout``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.algorithms import PartyLayout


def vertical_split(x: np.ndarray, q: int, m: int,
                   seed: int | None = None) -> Tuple[List[np.ndarray], PartyLayout]:
    """Partition columns of ``x`` into q nearly equal blocks (paper §7:
    "partitioned vertically and randomly into q non-overlapped parts").

    With ``seed`` set, columns are randomly permuted first (we keep the
    permuted order globally consistent so blocks are contiguous slices).
    """
    d = x.shape[1]
    if seed is not None:
        perm = np.random.default_rng(seed).permutation(d)
        x = x[:, perm]
    layout = PartyLayout.even(d, q, m)
    blocks = [x[:, lo:hi] for (lo, hi) in layout.bounds]
    return blocks, layout
