"""Synthetic dataset generators shaped like the paper's benchmarks.

A numpy copy of ``repro.data.synthetic``, kept here so the port imports
nothing of the JAX package; the same seed gives the same arrays.

The container is offline, so D1 (UCICreditCard), D2 (GiveMeSomeCredit),
D3 (news20), D4 (webspam), D5 (E2006-tfidf), D6 (YearPredictionMSD) are
replaced by generators matching their *statistical shape* (sample/feature
counts scaled to CPU budget, one-hot categorical blocks for the financial
sets, heavy-tailed sparse-ish features for the text-like sets).  A ground
truth w* with planted block structure guarantees all parties' features are
informative — which is what makes AFSVRG-VP (passive blocks frozen)
measurably lossy, as in paper Table 2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    task: str  # "classification" | "regression"


def _split(x, y, rng, train_frac=0.8):
    n = x.shape[0]
    perm = rng.permutation(n)
    k = int(n * train_frac)
    tr, te = perm[:k], perm[k:]
    return x[tr], y[tr], x[te], y[te]


def classification_dataset(name: str, n: int, d: int, seed: int = 0,
                           onehot_frac: float = 0.0,
                           noise: float = 0.8) -> Dataset:
    """Linearly separable-ish binary task with label noise."""
    rng = np.random.default_rng(seed)
    d_num = d - int(d * onehot_frac)
    x_num = rng.standard_normal((n, d_num)).astype(np.float32)
    cols = [x_num]
    d_cat = d - d_num
    if d_cat > 0:
        # one-hot blocks of width 4..8 (like the one-hot-encoded financial sets)
        widths = []
        while sum(widths) < d_cat:
            widths.append(min(int(rng.integers(4, 9)), d_cat - sum(widths)))
        for wd in widths:
            idx = rng.integers(0, wd, size=n)
            oh = np.zeros((n, wd), np.float32)
            oh[np.arange(n), idx] = 1.0
            cols.append(oh)
    x = np.concatenate(cols, axis=1)[:, :d]
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    w_star = rng.standard_normal(d).astype(np.float32)
    w_star *= (rng.random(d) < 0.9)  # mostly dense signal across all blocks
    logits = x @ w_star / np.sqrt(d)
    p = 1.0 / (1.0 + np.exp(-logits / noise))
    y = np.where(rng.random(n) < p, 1.0, -1.0).astype(np.float32)
    xtr, ytr, xte, yte = _split(x, y, rng)
    return Dataset(name, xtr, ytr, xte, yte, "classification")


def regression_dataset(name: str, n: int, d: int, seed: int = 0,
                       noise: float = 0.1) -> Dataset:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 0] = 1.0  # intercept column (the min-max-normalized target needs it)
    w_star = rng.standard_normal(d).astype(np.float32) / np.sqrt(d)
    y = x @ w_star + noise * rng.standard_normal(n).astype(np.float32)
    # min-max normalize targets (as the paper does for D6)
    y = (y - y.min()) / (y.max() - y.min())
    xtr, ytr, xte, yte = _split(x, y, rng)
    return Dataset(name, xtr, ytr, xte, yte, "regression")


def paper_datasets(scale: float = 1.0, seed: int = 0) -> Dict[str, Dataset]:
    """CPU-budget-scaled stand-ins for D1..D6 (shapes from paper Table 1)."""
    s = scale
    return {
        # financial (dense, one-hot categorical blocks)
        "D1": classification_dataset("D1", n=int(6000 * s), d=90, seed=seed,
                                     onehot_frac=0.4),
        "D2": classification_dataset("D2", n=int(9600 * s), d=92,
                                     seed=seed + 1, onehot_frac=0.4),
        # large-scale text-like (we scale features to CPU budget)
        "D3": classification_dataset("D3", n=int(4500 * s), d=2048,
                                     seed=seed + 2),
        "D4": classification_dataset("D4", n=int(8000 * s), d=4096,
                                     seed=seed + 3),
        # regression
        "D5": regression_dataset("D5", n=int(4000 * s), d=1024, seed=seed + 4),
        "D6": regression_dataset("D6", n=int(9000 * s), d=90, seed=seed + 5),
    }
