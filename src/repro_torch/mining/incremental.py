"""Incremental frontier re-mining over a sliding window (streaming).

The serving layer (``serving.streaming``) maintains exact supports
for its *active* bank patterns under a sliding window of sequences, and
records which active patterns the *arriving* sequences touched - i.e.
the arrival contained them.  That dirtiness signal makes re-mining
incremental, because containment is monotone along the reverse-search
``parent()`` chain (a sequence containing a pattern contains every
ancestor):

    If no arrival since the last reconcile contained pattern ``p``,
    then no pattern below ``p`` *gained* any support (a sequence
    containing a descendant contains ``p``).  Every non-active
    descendant was below ``minsup`` at the last reconcile and its
    support has only decreased since, so it is still infrequent; every
    active descendant's support is maintained exactly by the streaming
    layer regardless (arrivals counted by the join, expiries
    decremented from stored bitmaps).  ``p``'s subtree is *clean*: its
    active frequent descendants are retained at their maintained
    supports, and no scan below ``p`` can discover anything new.
    Expiries never dirty anything - they only shrink supports, which
    maintenance already accounts for.

``refresh_frontier`` therefore walks the reverse-search tree from the
root exactly like ``AcceleratedMiner.mine_rs`` (same scans, same
membership test, bit-equal supports) but prunes every clean subtree: a
clean active child is retained together with its active frequent
descendants (looked up by walking ``parent()`` chains) without a single
DB scan.  Dirty or unknown (new / previously tombstoned) children are
scanned and descended normally - the *boundary frontier*:
children of still-frequent patterns re-expanded via reverse search.
The result is exactly what a full re-mine of the window would produce
(tested against the JAX package's ``repro.mining.incremental`` and a
batch re-mine in tests/test_torch_streaming.py); a periodic full re-mine
(``StreamingBank.refresh(full=True)``) stays available as the
belt-and-braces exactness escape hatch and as bank compaction.

The per-child dirtiness index
-----------------------------
The dirtiness signal is *slot-granular* on the streaming side: the
ring's per-sequence containment bitmaps double as the dirtiness record,
and a per-slot ``fresh`` flag marks arrivals since the last reconcile.
``dirty`` is then "patterns contained in a fresh arrival *still in the
window*" - overwriting a ring slot drops its dirt, so under heavy churn
an arrival that transits the window entirely between two reconciles
dirties nothing, and ``refresh_frontier`` prunes subtrees an
accumulated dirty-bit scheme would have rescanned.

The same index coarsens to the per-child (depth-1 subtree) level:
``depth1_root(p)`` maps any pattern to its depth-1 reverse-search
ancestor, and ``subtree_dirty_rows`` widens a set of dirty depth-1
roots back to a per-row mask.  The coarse form is what the multi-host
sharded-window protocol (serving.cluster) all-reduces at ``refresh()``:
O(#depth-1 subtrees) flags instead of a bank-width bit row per host.
It is sound because containment is anti-monotone along the ``parent()``
chain - an arrival touching any pattern touches its depth-1 root, so a
clean root certifies a clean subtree - and refresh_frontier stays exact
under any dirty *superset* (it only ever scans more).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..core.graphseq import Pattern, TRSeq, pattern_length
from ..core.reverse_search import parent
from .driver import AcceleratedMiner
from .encoding import EmbBlock


@functools.lru_cache(maxsize=1 << 16)
def depth1_root(p: Pattern) -> Pattern:
    """The depth-1 reverse-search ancestor of ``p`` (``p`` itself when
    it is depth 1).  Containment is anti-monotone along the ``parent()``
    chain, so any sequence containing ``p`` contains its depth-1 root -
    the soundness of subtree-level dirtiness.  Memoized process-wide:
    ``parent()`` re-canonicalizes at every chain link, and the sharded
    refresh asks for every bank pattern's root on each reconcile (the
    recursion memoizes every ancestor along the way)."""
    up = parent(p)
    if up is None or not up:
        return p
    return depth1_root(up)


def subtree_dirty_rows(
    patterns: Sequence[Pattern], dirty_roots: Set[Pattern]
) -> np.ndarray:
    """Widen a set of dirty depth-1 subtree roots to a per-bank-row
    bool mask (True = the row's subtree was touched).  The coarse,
    all-reducible form of the dirtiness index - see the module
    docstring."""
    return np.asarray(
        [depth1_root(p) in dirty_roots for p in patterns], bool
    )


@dataclasses.dataclass
class FrontierResult:
    """Outcome of one frontier refresh: the exact frequent-pattern map
    over the window plus the work accounting that makes the incremental
    claim measurable (``scans`` vs ``scans_skipped``)."""

    patterns: Dict[Pattern, int]
    # exact containing-sequence sets (window gid -> bool) for every
    # *scanned* pattern - the streaming layer backfills recovered/new
    # rows' window bitmaps from these, no separate containment join.
    # Retained (clean) patterns are absent: their ring bitmaps are
    # already exact.
    gids: Dict[Pattern, Set[int]] = dataclasses.field(
        default_factory=dict)
    scans: int = 0            # extension scans actually run
    scans_skipped: int = 0    # clean frequent subtree roots pruned
    retained: int = 0         # patterns kept from maintained supports
    discovered: int = 0       # patterns found by scanning (new or dirty)
    # per-child accounting: of the root's frequent children, how many
    # whole depth-1 subtrees were pruned clean vs descended dirty
    depth1_clean: int = 0
    depth1_dirty: int = 0


def _ancestor_chains(
    patterns: Sequence[Pattern],
) -> Dict[Pattern, List[Pattern]]:
    """Each pattern's reverse-search ancestor chain (excluding the
    root), memoized across the batch - used to retain a clean pattern's
    known frequent descendants without scanning."""
    chains: Dict[Pattern, List[Pattern]] = {}

    def chain(p: Pattern) -> List[Pattern]:
        got = chains.get(p)
        if got is not None:
            return got
        q = parent(p)
        out: List[Pattern] = [] if q is None or not q else chain(q) + [q]
        chains[p] = out
        return out

    for p in patterns:
        chain(p)
    return chains


def refresh_frontier(
    db: Sequence[TRSeq],
    min_support: int,
    *,
    active: Dict[Pattern, int],
    dirty: Set[Pattern],
    any_change: bool = True,
    max_len: Optional[int] = None,
    miner: Optional[AcceleratedMiner] = None,
    **miner_kw,
) -> FrontierResult:
    """Re-mine the window ``db`` incrementally.

    ``active`` maps the maintained (exactly counted) frequent patterns
    to their current window supports; ``dirty`` is the subset contained
    in at least one *arrival* since the supports were last reconciled
    (the only events that can add support anywhere below a pattern).
    Patterns outside ``active`` (new or tombstoned) have unknown
    supports and are always treated as dirty.  ``any_change=False``
    asserts no window change at all happened, making the whole walk a
    no-op retention.

    Returns the exact ``{pattern: support}`` map a full
    ``mine_rs(min_support, max_len)`` over ``db`` would produce.  The
    miner's capacity guards (``max_itemsets``/``max_vertices``) apply
    identically - pass ``miner`` or ``miner_kw`` to match the miner that
    built the bank; ``miner_kw`` carries ``device`` (``cuda`` unless
    given), where every scan of the walk runs."""
    res = FrontierResult(patterns={})
    frequent_active = {
        p: s for p, s in active.items() if s >= min_support
    }
    if not any_change:
        res.patterns.update(frequent_active)
        res.retained = len(frequent_active)
        return res
    if miner is None:
        miner = AcceleratedMiner(db, **miner_kw)
    assert len(miner.db) == len(db), "miner must be bound to the window"
    chains = _ancestor_chains(list(frequent_active))
    # descendants[c] = active frequent patterns strictly below c
    descendants: Dict[Pattern, List[Pattern]] = {}
    for p in frequent_active:
        for anc in chains[p]:
            descendants.setdefault(anc, []).append(p)

    def is_clean(p: Pattern) -> bool:
        return p in active and p not in dirty

    def want_embs(child: Pattern) -> bool:
        # clean children are retained, never descended - skip the
        # embedding rebuild (the expensive host part of a scan)
        return not is_clean(child)

    # same wavefront scheduling as AcceleratedMiner._mine: the dirty
    # frontier is drained in slices and every slice's scans share
    # packed device chunks, so streaming refresh() and the sharded
    # reconcile get the cross-pattern batching for free
    root: Pattern = ()
    pending = deque([(root, EmbBlock.root(len(db), miner.ni, miner.nv))])
    while pending:
        items = miner._take_slice(pending, max_len, wavefront=True)
        if not items:
            break  # guards drained the pool
        res.scans += len(items)
        for (pattern, _), kids in zip(items, miner.expand_children_batch(
            items, min_support, rs=True, want_embs=want_embs
        )):
            for child, gids, child_embs in kids:
                res.patterns[child] = len(gids)
                if pattern == root:
                    if is_clean(child):
                        res.depth1_clean += 1
                    else:
                        res.depth1_dirty += 1
                if is_clean(child):
                    # clean subtree: no window change touched child, so
                    # no descendant's support changed - retain the known
                    # frequent ones, prune the scan
                    res.scans_skipped += 1
                    res.retained += 1
                    for q in descendants.get(child, ()):
                        res.patterns[q] = active[q]
                        res.retained += 1
                else:
                    res.gids[child] = gids
                    res.discovered += 1
                    pending.append((child, child_embs))
    return res
