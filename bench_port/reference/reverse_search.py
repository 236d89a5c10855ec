"""GTRACE-RS: reverse-search enumeration of rFTSs (Sec. 3-4).

The parent functions P1/P2/P3 (Defs 8-10) define a spanning tree over the
set of canonical relevant FTSs; traversing it from the root enumerates
*only* relevant patterns, which is the paper's source of speedup.

``parent`` implements the P1 > P2 > P3 priority exactly:

* P1 - the pattern contains vertex TRs: remove the temporally last vertex
  TR (ties inside an itemset broken by the encoded-tuple order on the
  canonical representation; any fixed rule yields a valid spanning tree).
* P2 - only edge TRs and more TRs than union-graph edges: among the TRs
  that have an earlier (strictly smaller itemset index) TR on the same
  union-graph edge, remove the temporally last.  (See DESIGN.md for why
  Def 9 is read "among"-style; the literal reading leaves some rFTSs
  parentless.)
* P3 - every TR on a distinct union-graph edge: remove the temporally
  last TR whose removal keeps the union graph connected.

Children are produced generate-and-verify: the DB scan proposes every
relevance-preserving one-TR insertion observed in the data (complete by
the occurrence-list argument in ``enumerate_host``), and a candidate is
kept iff ``parent(child) == node`` - exactly the reverse-search membership
test ``s_p diamond r in P_i^{-1}(s_p)`` of Fig. 11.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .canonical import canonical_code, canonical_form, canonical_map
from .enumerate_host import (
    Emb,
    apply_extension,
    find_extensions,
    merge_extensions_by_canonical,
    remap_embedding,
    root_embeddings,
)
from .gtrace import MiningResult
from .graphseq import (
    Pattern,
    TR,
    TRSeq,
    pattern_length,
    pattern_vertices,
)
from .union_graph import is_relevant, pattern_union_graph


def _tr_key(tr: TR) -> Tuple[int, int, int, int]:
    return (int(tr.type), tr.u1, tr.u2, tr.label)


def _remove(pattern: Pattern, idx: int, tr: TR) -> Pattern:
    out = []
    for i, itemset in enumerate(pattern):
        if i == idx:
            rest = itemset - {tr}
            if rest:
                out.append(rest)
        else:
            out.append(itemset)
    return tuple(out)


def parent(p: Pattern) -> Optional[Pattern]:
    """The unique reverse-search parent (canonical form), None for the root
    or for pathological patterns outside S (never generated from compiled
    data)."""
    if not p:
        return None
    has_vertex = any(tr.is_vertex for s in p for tr in s)
    if has_vertex:
        # P1: last itemset containing a vertex TR, max-tuple tie-break
        for i in range(len(p) - 1, -1, -1):
            vtrs = [tr for tr in p[i] if tr.is_vertex]
            if vtrs:
                tr = max(vtrs, key=_tr_key)
                return canonical_form(_remove(p, i, tr))
        raise AssertionError("unreachable")
    ug = pattern_union_graph(p)
    if pattern_length(p) > len(ug.edges):
        # P2: among TRs with an earlier same-edge TR, remove the last
        seen_edges = set()
        candidates: List[Tuple[int, TR]] = []
        for i, itemset in enumerate(p):
            here = sorted(itemset, key=_tr_key)
            for tr in here:
                if tr.edge in seen_edges:
                    candidates.append((i, tr))
            seen_edges.update(tr.edge for tr in here)
        if not candidates:
            return None  # duplicates only inside one itemset: outside S
        i, tr = max(candidates, key=lambda it: (it[0], _tr_key(it[1])))
        return canonical_form(_remove(p, i, tr))
    # P3: last TR whose removal keeps the union graph connected
    for i in range(len(p) - 1, -1, -1):
        for tr in sorted(p[i], key=_tr_key, reverse=True):
            cand = _remove(p, i, tr)
            if is_relevant(cand):
                return canonical_form(cand)
    return None  # disconnected input: outside S


def mine_gtrace_rs(
    db: Sequence[TRSeq],
    min_support: int,
    max_len: int | None = None,
) -> MiningResult:
    """Enumerate all rFTSs by reverse search (Fig. 11)."""
    res = MiningResult()

    def expand(node: Pattern, embs: List[Emb]) -> None:
        if max_len is not None and pattern_length(node) >= max_len:
            return
        nv = len(pattern_vertices(node))
        has_vertex = any(tr.is_vertex for s in node for tr in s)
        empty = not node

        def allow(slot, tr: TR) -> bool:
            if tr.is_vertex:
                # P1-class child: vertex TR on an existing union-graph
                # vertex (fresh only from the root -> single-vertex chains)
                return empty or tr.u1 < nv
            # edge TR children only exist below edge-only nodes
            if has_vertex:
                return False
            # P2-class (duplicate TR on existing edge) or P3-class (new
            # union-graph edge attached to the existing component)
            if tr.u1 >= nv and tr.u2 >= nv:
                return empty  # both endpoints fresh: single-edge patterns
            return True

        res.n_extension_scans += 1
        exts = find_extensions(node, embs, db, allow)
        merged = merge_extensions_by_canonical(node, exts)
        for child, (gids, child_embs) in merged.items():
            if len(gids) < min_support:
                continue
            if parent(child) != node:
                continue  # reverse-search membership test
            res.patterns[child] = len(gids)
            res.n_enumerated += 1
            expand(child, child_embs)

    root: Pattern = ()
    expand(root, root_embeddings(db))
    return res
