"""EmbeddingBag for recsys, built as the JAX package builds it: a row take
(``kernels.take_rows``) and segment sums / maxima (``models.common``)
over ragged multi-hot bags, with no ``nn.EmbeddingBag``.

Bags are given in "flat + segment" form: ``indices`` [NNZ] row ids into
the table, ``segments`` [NNZ] bag ids (sorted), optional ``weights``.
Padding entries use index 0 with weight 0.  JAX's index rules hold: an
index in ``[-V, 0)`` wraps, any other index out of range reads a NaN
row; a bag id outside ``[0, n_bags)`` is dropped; an empty bag is 0 in
sum and mean mode and ``-inf`` in max mode.
"""
from __future__ import annotations

import torch

from ..kernels import take_rows
from .common import segment_max, segment_sum


def embedding_bag(
    table,          # [V, D]
    indices,        # [NNZ] int32
    segments,       # [NNZ] int32 (bag id per entry)
    n_bags: int,
    weights=None,   # [NNZ] or None
    mode: str = "sum",
):
    rows = take_rows(table, indices)  # [NNZ, D]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    if mode == "sum":
        return segment_sum(rows, segments, n_bags)
    if mode == "mean":
        s = segment_sum(rows, segments, n_bags)
        ones = (weights if weights is not None
                else torch.ones(indices.shape, dtype=rows.dtype,
                                device=rows.device))
        cnt = segment_sum(ones.to(rows.dtype), segments, n_bags)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        return segment_max(rows, segments, n_bags)
    raise ValueError(mode)
