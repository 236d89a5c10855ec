"""Synthetic user-session data for BERT4Rec: cluster-structured item
sequences + Cloze masking, and session graph-sequences feeding the GTRACE
mining integration example."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def session_batches(
    seed: int, n_items: int, batch: int, seq: int, n_masked: int,
    mask_id: int, n_negatives: int = 1024, n_clusters: int = 64,
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    cluster_size = max(2, n_items // n_clusters)
    while True:
        cl = rng.integers(0, n_clusters, batch)
        base = 1 + cl * cluster_size
        seqs = (
            base[:, None]
            + rng.integers(0, cluster_size, (batch, seq))
        ).astype(np.int32)
        seqs = np.clip(seqs, 1, n_items)
        lengths = rng.integers(seq // 2, seq + 1, batch)
        pad = np.arange(seq)[None] >= lengths[:, None]
        seqs[pad] = 0
        masked_pos = np.stack(
            [rng.choice(max(l, n_masked), n_masked, replace=False)
             .clip(0, l - 1) if l > 0 else np.zeros(n_masked, np.int64)
             for l in lengths]
        ).astype(np.int32)
        masked_ids = np.take_along_axis(seqs, masked_pos, 1)
        inp = seqs.copy()
        np.put_along_axis(inp, masked_pos, mask_id, 1)
        negatives = rng.integers(1, n_items + 1, n_negatives).astype(
            np.int32
        )
        yield {
            "seq": inp,
            "masked_pos": masked_pos,
            "masked_ids": masked_ids,
            "negatives": negatives,
        }
