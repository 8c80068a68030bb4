"""Token data for LM training (a numpy copy of ``repro.data.tokens``: the
same seed gives the same tokens bit for bit).

Nothing is downloaded: a deterministic synthetic language, a
Zipf-distributed token process with short-range Markov structure (so a
model can push the loss below the unigram entropy, and a training curve
means something).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seed: int = 0
    zipf_a: float = 1.2

    def batches(self, batch: int, seq: int) -> Iterator[np.ndarray]:
        """Endless (batch, seq) int32 arrays: a Zipf marginal over
        ``min(vocab, 32768)`` ids, each position after the first
        repeating its predecessor + 1 (mod that alphabet) with
        probability 1/2."""
        rng = np.random.default_rng(self.seed)
        v_eff = min(self.vocab, 32768)
        ranks = np.arange(1, v_eff + 1)
        p = ranks ** (-self.zipf_a)
        p /= p.sum()
        while True:
            base = rng.choice(v_eff, size=(batch, seq), p=p)
            rep = rng.random((batch, seq)) < 0.5
            out = base.copy()
            for t in range(1, seq):
                out[:, t] = np.where(rep[:, t], (out[:, t - 1] + 1) % v_eff,
                                     base[:, t])
            yield out.astype(np.int32)


def synthetic_token_batches(vocab: int, batch: int, seq: int, steps: int,
                            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """``steps`` batches {"tokens", "labels"}, each (batch, seq) int32,
    the labels the tokens shifted by one position."""
    it = TokenStream(vocab, seed).batches(batch, seq + 1)
    for _ in range(steps):
        tokens = next(it)
        yield {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
