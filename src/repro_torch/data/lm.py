"""Synthetic LM token streams (zipf-distributed with local structure so a
small model's loss visibly decreases)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def token_batches(
    seed: int, vocab: int, batch: int, seq: int
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    # a random order-1 markov chain gives learnable structure
    k = min(vocab, 512)
    trans = rng.dirichlet(np.ones(k) * 0.05, size=k).astype(np.float32)
    cum = np.cumsum(trans, axis=1)
    while True:
        state = rng.integers(0, k, batch)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = state
        u = rng.random((batch, seq)).astype(np.float32)
        for t in range(seq):
            state = (cum[state] < u[:, t : t + 1]).sum(1).clip(0, k - 1)
            toks[:, t + 1] = state
        yield {"tokens": toks[:, :-1] % vocab, "targets": toks[:, 1:] % vocab}
