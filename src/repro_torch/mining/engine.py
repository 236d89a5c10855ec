"""Vectorized embedding-join extension discovery (the device hot loop).

This is the GPU realization of the paper's Sec. 4.3 insight: once a
pattern occurrence fixes the vertex-ID mapping psi, checking whether a data
TR extends the pattern is an O(1) token comparison - no isomorphism test.
We evaluate that comparison for every (embedding x data-TR) pair on the
device and reduce to per-candidate supports on the host.

``match_signatures`` computes, for each (embedding e, token t), a packed
int32 *extension signature* describing the one-TR extension (slot + TR in
pattern coordinates) that the token would realize, or -1 when the token
cannot extend the embedding under the current search phase:

* mode 0 (RS root)        - anything, incl. fresh-vertex / fresh-edge TRs
* mode 1 (RS, node has vertex TRs)   - vertex TRs on mapped vertices only
* mode 2 (RS, edge-only node)        - vertex TRs on mapped vertices,
  edge TRs with >=1 mapped endpoint (P2/P3-class children)
* mode 3 (GTRACE baseline)           - anything, tail slots only

Both scans are the match_count kernel (``kernels.match_count.ops``): on a
CUDA tensor its hand-written CUDA kernel, on a CPU tensor its plain
PyTorch version.  Supports are distinct-gid counts per signature;
`aggregate_host` is the exact numpy finalize (vectorized: one sort +
boundary split, no per-signature python).

``match_signatures_batch`` / ``aggregate_host_batch`` are the wavefront
forms: rows of *different* patterns share one dispatch, carrying a
per-row ``pattern_id`` that indexes stacked per-pattern tables on the
way in and namespaces the signatures on the way out (the 64-bit
``pattern_id << 32 | sig`` key) - see mining.driver's wavefront
scheduler.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np

from ..kernels.match_count.ops import (  # noqa: F401
    match_signatures_batch,
    match_signatures_kernel as match_signatures,
)
from ..kernels.match_count.ref import (  # noqa: F401
    MODE_EDGE_PHASE,
    MODE_ROOT,
    MODE_TAIL,
    MODE_VERTEX_PHASE,
)


def _group_finalize(svals, e_idx, t_idx, g):
    """Shared vectorized finalize core: sort the surviving
    (signature, e, t, gid) rows once by signature, split the (e,t) rows
    at the signature boundaries, and dedup (signature, gid) pairs with a
    second sort - no per-signature ``set(tolist())`` over the
    duplicate-heavy raw rows.  Returns (signature keys ascending,
    per-key distinct-gid arrays, per-key (e,t) row arrays ordered by
    (e,t))."""
    order = np.lexsort((t_idx, e_idx, svals))
    svals = svals[order]
    e_idx = e_idx[order]
    t_idx = t_idx[order]
    g = g[order]
    bounds = np.nonzero(np.diff(svals))[0] + 1
    et_groups = np.split(np.stack([e_idx, t_idx], axis=1), bounds)
    gorder = np.lexsort((g, svals))
    s2, g2 = svals[gorder], g[gorder]
    keep = np.empty(len(s2), bool)
    keep[:1] = True
    keep[1:] = (s2[1:] != s2[:-1]) | (g2[1:] != g2[:-1])
    s2, g2 = s2[keep], g2[keep]
    gid_groups = np.split(g2, np.nonzero(np.diff(s2))[0] + 1)
    keys = svals[np.concatenate([[0], bounds])]
    return keys, gid_groups, et_groups


def aggregate_host(
    sigs: np.ndarray, gids: np.ndarray
) -> Dict[int, Tuple[Set[int], np.ndarray]]:
    """Exact finalize: signature -> (distinct gid set, (e,t) index array)."""
    E, T = sigs.shape
    flat = sigs.reshape(-1)
    idx = np.nonzero(flat >= 0)[0]
    if not len(idx):
        return {}
    svals = flat[idx]
    e_idx = (idx // T).astype(np.int32)
    t_idx = (idx % T).astype(np.int32)
    g = np.asarray(gids)[e_idx]
    keys, gid_groups, et_groups = _group_finalize(svals, e_idx, t_idx, g)
    return {
        int(s): (set(gg.tolist()), et)
        for s, gg, et in zip(keys, gid_groups, et_groups)
    }


def aggregate_host_batch(
    sigs: np.ndarray, gids: np.ndarray, pids: np.ndarray
) -> Dict[Tuple[int, int], Tuple[Set[int], np.ndarray]]:
    """Namespaced finalize for wavefront scans: each row carries the
    pattern id it belongs to (``pids`` [E]), so signatures of different
    patterns in the same packed batch are disambiguated by composing a
    64-bit ``pattern_id << 32 | sig`` sort key.  Returns
    {(pattern_id, sig): (distinct gid set, (e,t) rows)} with ``e``
    indexing the packed batch rows (the driver maps them back to
    per-pattern embedding indices)."""
    E, T = sigs.shape
    flat = sigs.reshape(-1).astype(np.int64)
    idx = np.nonzero(flat >= 0)[0]
    if not len(idx):
        return {}
    e_idx = (idx // T).astype(np.int32)
    t_idx = (idx % T).astype(np.int32)
    svals = (np.asarray(pids, np.int64)[e_idx] << 32) | flat[idx]
    g = np.asarray(gids)[e_idx]
    keys, gid_groups, et_groups = _group_finalize(svals, e_idx, t_idx, g)
    return {
        (int(k >> 32), int(k & 0xFFFFFFFF)): (set(gg.tolist()), et)
        for k, gg, et in zip(keys, gid_groups, et_groups)
    }
