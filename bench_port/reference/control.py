"""The control: the reference with one exactness guarantee broken.

The configurations state no precision; what they guarantee is exactness
(every rFTS at or above the support threshold with its exact support, and
every served row equal to Def. 4 containment).  The control breaks that
guarantee the way a tempting shortcut would, and the comparison that
decides ``correct`` has to fail it:

* ``mine_capped``: GTRACE-RS that keeps at most ``per_seq`` embeddings
  of a pattern per data sequence, as a miner that caps its embedding
  lists to save memory would.  Children that only an embedding it
  dropped would have found go missing, and supports come out low.
* ``contains_capped``: containment over a frontier of at most ``cap``
  partial embeddings, answering "not contained" once the frontier
  overflows and the match lies beyond it: the serving join at ``emax``
  with neither the wider retry nor the host oracle behind it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from .containment import _match_itemset
from .enumerate_host import Emb, find_extensions, merge_extensions_by_canonical, root_embeddings
from .gtrace import MiningResult
from .graphseq import TR, Pattern, TRSeq, pattern_length, pattern_vertices
from .reverse_search import parent


def _cap_per_seq(embs: List[Emb], per_seq: int) -> List[Emb]:
    seen: Dict[int, int] = {}
    out = []
    for e in embs:
        n = seen.get(e[0], 0)
        if n < per_seq:
            seen[e[0]] = n + 1
            out.append(e)
    return out


def mine_capped(db: Sequence[TRSeq], min_support: int,
                max_len: int | None = None, per_seq: int = 1) -> MiningResult:
    """``reverse_search.mine_gtrace_rs`` with every child's embedding list
    cut to its first ``per_seq`` embeddings in each sequence."""
    res = MiningResult()

    def expand(node: Pattern, embs: List[Emb]) -> None:
        if max_len is not None and pattern_length(node) >= max_len:
            return
        nv = len(pattern_vertices(node))
        has_vertex = any(tr.is_vertex for s in node for tr in s)
        empty = not node

        def allow(slot, tr: TR) -> bool:
            if tr.is_vertex:
                return empty or tr.u1 < nv
            if has_vertex:
                return False
            if tr.u1 >= nv and tr.u2 >= nv:
                return empty
            return True

        res.n_extension_scans += 1
        exts = find_extensions(node, embs, db, allow)
        for child, (gids, child_embs) in merge_extensions_by_canonical(
                node, exts).items():
            if len(gids) < min_support or parent(child) != node:
                continue
            res.patterns[child] = len(gids)
            res.n_enumerated += 1
            expand(child, _cap_per_seq(child_embs, per_seq))

    expand((), root_embeddings(db))
    return res


def contains_capped(p: Pattern, s: TRSeq, cap: int) -> bool:
    """Def. 4 containment searched itemset by itemset over a frontier of
    at most ``cap`` partial embeddings (the first found); whatever lies
    beyond a full frontier is never looked at."""
    frontier = [(0, {})]
    for itemset in p:
        nxt = []
        for start, psi in frontier:
            for di in range(start, len(s)):
                for new_psi in _match_itemset(list(itemset), s[di], dict(psi),
                                              set(psi.values())):
                    nxt.append((di + 1, new_psi))
                    if len(nxt) >= cap:
                        break
                if len(nxt) >= cap:
                    break
            if len(nxt) >= cap:
                break
        if not nxt:
            return False
        frontier = nxt
    return True
