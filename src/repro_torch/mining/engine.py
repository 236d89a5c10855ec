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
PyTorch version (``match_signatures_ref`` / ``match_signatures_batch_ref``
are those plain versions).  Supports are distinct-gid counts per
signature; `aggregate_host` is the exact numpy finalize (vectorized: one
sort + boundary split, no per-signature python), `candidate_table_device`
the fixed-size on-device variant used by the distributed step (see
distributed.py).

``match_signatures_batch`` is the wavefront form: rows of *different*
patterns share one dispatch, carrying a per-row ``pattern_id`` that
indexes stacked per-pattern tables on the way in and namespaces the
signatures on the way out (the 64-bit ``pattern_id << 32 | sig`` key).
``signature_entries`` keeps a chunk's valid signatures as flat arrays,
and ``group_slice`` groups a whole wavefront slice's entries by key with
one stable sort (``SliceGroups``) - see mining.driver's wavefront
scheduler; ``bound_slice`` bounds each key's children's support with
one sort of the keys, so the keys that cannot reach the minimum support
skip mining.driver's per-key canonicalisation; ``aggregate_host_batch``
is one chunk's grouping as a dict.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Set, Tuple

import numpy as np
import torch

from ..kernels.match_count.ops import (  # noqa: F401
    match_signatures_batch,
    match_signatures_kernel as match_signatures,
)
from ..kernels.match_count.ref import (  # noqa: F401
    MODE_EDGE_PHASE,
    MODE_ROOT,
    MODE_TAIL,
    MODE_VERTEX_PHASE,
    match_signatures_batch_ref,
    match_signatures_ref,
)
from .encoding import (INVALID_SIG, _LAB_BITS, _SL_BITS, _TY_BITS,
                       unpack_signature)


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


def signature_entries(sigs: np.ndarray, gids: np.ndarray,
                      pids: np.ndarray):
    """A wavefront chunk's valid signatures (``sigs`` [E, T], ``-1`` for
    none) as four flat arrays in (e, t) order: the 64-bit key
    ``pids[e] << 32 | sig``, the chunk row ``e``, the token ``t`` and
    the row's gid."""
    T = sigs.shape[1]
    flat = sigs.reshape(-1)
    idx = np.flatnonzero(flat >= 0)
    e = idx // T
    keys = (np.asarray(pids, np.int64)[e] << 32) | flat[idx]
    return keys, e, idx - e * T, np.asarray(gids)[e]


class SliceGroups(NamedTuple):
    """A wavefront slice's extension signatures grouped by (item,
    signature) key.  The keys run item by item; within an item, in the
    order a chunk-by-chunk merge first meets them (by the first chunk
    holding the signature, then ascending signature).  Key ``k`` has
    signature ``sig[k]``, its (e, t) rows ``e[row_lo[k]:row_hi[k]]`` /
    ``t[...]`` in (e, t) order with ``e`` local to the item's embedding
    block, and its distinct gids ``gids[gid_lo[k]:gid_hi[k]]``
    ascending; item ``i`` owns keys ``items[i]:items[i + 1]``."""

    sig: np.ndarray
    row_lo: np.ndarray
    row_hi: np.ndarray
    e: np.ndarray
    t: np.ndarray
    gid_lo: np.ndarray
    gid_hi: np.ndarray
    gids: np.ndarray
    items: np.ndarray


def group_slice(chunks: Sequence[Tuple[np.ndarray, ...]],
                offs: np.ndarray) -> SliceGroups:
    """Group the entries of a slice's chunks, in chunk order, each a
    ``(keys, rows, t, gids)`` of ``signature_entries`` with ``rows``
    counted from the slice's first row; ``offs`` [n_items] is each
    item's first row.  One stable sort by key keeps every key's rows in
    their (e, t) order, and one sort of (key, gid) pairs finds each
    key's distinct gids."""
    offs = np.asarray(offs, np.int64)
    if chunks:
        keys, rows, t, gids = (np.concatenate(c) for c in zip(*chunks))
        chunk = np.repeat(np.arange(len(chunks)),
                          [len(c[0]) for c in chunks])
    else:
        keys = np.zeros(0, np.int64)
        rows = t = gids = chunk = np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    new = np.ones(len(keys), bool)
    new[1:] = keys[1:] != keys[:-1]
    lo = np.flatnonzero(new)
    hi = np.append(lo[1:], len(keys))
    ukeys = keys[lo]
    pid = ukeys >> 32
    # one key a group: distinct (group, gid) pairs, grouped and ascending
    pairs = np.unique(((np.cumsum(new) - 1) << 32) | gids[order])
    grp = pairs >> 32
    kidx = np.arange(len(ukeys))
    korder = np.lexsort((ukeys, chunk[order[lo]], pid))
    return SliceGroups(
        sig=(ukeys & 0xFFFFFFFF)[korder],
        row_lo=lo[korder], row_hi=hi[korder],
        e=rows[order] - offs[keys >> 32], t=t[order],
        gid_lo=np.searchsorted(grp, kidx)[korder],
        gid_hi=np.searchsorted(grp, kidx, side="right")[korder],
        gids=pairs & 0xFFFFFFFF,
        items=np.searchsorted(pid[korder], np.arange(len(offs) + 1)),
    )


def bound_slice(groups: SliceGroups, n_vertices: np.ndarray,
                min_support: int) -> np.ndarray:
    """A keep mask over a slice's keys: ``False`` where no child the key
    can yield reaches ``min_support``.  ``n_vertices`` [n_items] is each
    item's pattern vertex count.

    Every key of an item that yields a given canonical child agrees on
    the slot kind (the child's itemset count), the ``in`` index (its
    itemset sizes), the TR's type and label (its (type, label)
    multiset) and the number of new vertices (its vertex count), since
    a signature never repeats a TR of its ``in`` itemset.  A child's
    gids are the union of its keys' gids, so its support is at most the
    sum of the gid counts of the keys in its bucket of these fields: one
    sort of the slice's keys, and no sort of their gids."""
    item = np.repeat(np.arange(len(groups.items) - 1),
                     np.diff(groups.items))
    n = np.asarray(n_vertices, np.int64)[item]
    # unpacked from a copy: the shifts work in place on an array
    kind, idx, ty, pu1, pu2, label = unpack_signature(
        groups.sig.astype(np.int64))
    # ty > 2: an edge TR, whose pu2 may be a second new vertex
    new = (pu1 >= n).astype(np.int64) + ((ty > 2) & (pu2 >= n))
    idx = np.where(kind == 0, idx, 0)  # a gap's index is not kept
    code = (item << 1 | kind) << _SL_BITS | idx
    code = ((code << _TY_BITS | ty) << 2 | new) << _LAB_BITS | (label + 1)
    _, bucket = np.unique(code, return_inverse=True)
    bound = np.bincount(bucket, weights=groups.gid_hi - groups.gid_lo)
    return bound[bucket] >= min_support


def aggregate_host_batch(
    sigs: np.ndarray, gids: np.ndarray, pids: np.ndarray
) -> Dict[Tuple[int, int], Tuple[Set[int], np.ndarray]]:
    """One chunk grouped as a dict, as the reference package's public
    form has it: {(pattern_id, sig): (distinct gid set, (e, t) rows
    [n, 2] int32)} in ascending key order, ``e`` indexing the chunk's
    rows.  The miner itself groups whole slices (``group_slice``)."""
    keys, e, t, g = signature_entries(sigs, gids, pids)
    n_items = int(keys.max() >> 32) + 1 if len(keys) else 0
    gr = group_slice([(keys, e, t, g)], np.zeros(n_items, np.int64))
    out = {}
    for pi in range(n_items):
        for k in range(gr.items[pi], gr.items[pi + 1]):
            rows = slice(gr.row_lo[k], gr.row_hi[k])
            out[(pi, int(gr.sig[k]))] = (
                set(gr.gids[gr.gid_lo[k]:gr.gid_hi[k]].tolist()),
                np.stack([gr.e[rows], gr.t[rows]], axis=1).astype(np.int32))
    return out


def _unique_fixed(x: torch.Tensor, k: int):
    """``jnp.unique(x, size=k, fill_value=INVALID_SIG,
    return_inverse=True)``: the sorted distinct values cut to ``k`` and
    padded with ``INVALID_SIG`` (a real -1 takes a slot like any value),
    and for each element its index into the *full* sorted distinct
    values, so an element whose value was cut off gets an index >= k.
    Every shape follows from ``x``'s and ``k`` (a sort, a running count
    of new values and two scatters), so a ``FakeTensorMode`` trace runs
    it as the device does."""
    srt, order = torch.sort(x)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    rank = torch.cumsum(new, 0) - 1  # each sorted element's distinct index
    inv = torch.empty_like(rank)
    inv[order] = rank
    uniq = torch.full((k + 1,), int(INVALID_SIG), dtype=x.dtype,
                      device=x.device)
    uniq[torch.where(new & (rank < k), rank, k)] = srt
    return uniq[:k], inv


def _segment_sum(vals: torch.Tensor, inv: torch.Tensor, k: int):
    """``jax.ops.segment_sum(vals, inv, num_segments=k)`` as int32: the
    entries whose segment is >= k are dropped (summed into a spare slot
    past the end)."""
    out = torch.zeros((k + 1,), dtype=torch.int32, device=vals.device)
    slots = torch.where(inv < k, inv, k)
    return out.index_add_(0, slots, vals.to(torch.int32))[:k]


def _lexsort_pairs(sig: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The order of ``jnp.lexsort((gid, sig))``: by signature, then by
    gid, each as a signed int32; two stable sorts."""
    by_gid = torch.sort(gid, stable=True).indices
    return by_gid[torch.sort(sig[by_gid], stable=True).indices]


def _shifted(x: torch.Tensor, first: int) -> torch.Tensor:
    """``x`` moved one place right, ``first`` in front: each element's
    predecessor in a sorted run."""
    return torch.cat([x.new_full((1,), first), x[:-1]])


def _pair_table(flat_sig: torch.Tensor, flat_gid: torch.Tensor, k: int, *,
                gid_pads: bool = False):
    """(sig -> distinct-gid count) table [k] of flat (sig, gid) pairs,
    which may repeat, and the count of distinct real signatures (int32
    0-d).  With ``gid_pads`` a pair whose gid is < 0 is a pad and counts
    for nothing."""
    order = _lexsort_pairs(flat_sig, flat_gid)
    ss, gg = flat_sig[order], flat_gid[order]
    new_sig = ss != _shifted(ss, -2)
    contrib = (new_sig | (gg != _shifted(gg, -2))) & (ss >= 0)
    if gid_pads:
        contrib &= gg >= 0
    n_distinct = (new_sig & (ss >= 0)).sum().to(torch.int32)
    uniq, inv = _unique_fixed(ss, k)
    counts = _segment_sum(contrib, inv, k)
    return uniq, torch.where(uniq >= 0, counts, 0), n_distinct


def _row_pairs(sigs: torch.Tensor, gids: torch.Tensor):
    """The (sig, gid) pairs of a [E, T] signature matrix, flat."""
    E, T = sigs.shape
    return sigs.reshape(-1), gids[:, None].expand(E, T).reshape(-1)


def candidate_table_device(sigs: torch.Tensor, gids: torch.Tensor, k: int):
    """Fixed-size on-device candidate table.

    Returns (uniq_sigs [k], distinct_gid_counts [k]), both int32.  Exact
    when the number of distinct signatures in this shard is < k (the
    driver checks and re-runs with larger k otherwise; -1 rows are pads).
    """
    return _pair_table(*_row_pairs(sigs, gids), k)[:2]


def merge_tables(uniq_list: Sequence[torch.Tensor],
                 counts_list: Sequence[torch.Tensor], k: int):
    """Merge per-shard (sig,count) tables by summing counts per signature
    (gid shards are disjoint so distinct-gid counts add)."""
    uniq, inv = _unique_fixed(torch.cat(list(uniq_list)), k)
    counts = _segment_sum(torch.cat(list(counts_list)), inv, k)
    return uniq, torch.where(uniq >= 0, counts, 0)
