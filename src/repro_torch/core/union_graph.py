"""Union graphs and relevance (Defs 5-6).

The union graph of a transformation (sub)sequence collects every vertex ID
touched by any TR and every vertex-ID pair touched by any edge TR.  A
pattern is *relevant* iff its union graph is connected.
"""
from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

from .graphseq import Pattern, TR


class UnionGraph:
    __slots__ = ("vertices", "edges")

    def __init__(self) -> None:
        self.vertices: Set[int] = set()
        self.edges: Set[Tuple[int, int]] = set()

    def add_tr(self, tr: TR) -> None:
        if tr.is_vertex:
            self.vertices.add(tr.u1)
        else:
            self.vertices.add(tr.u1)
            self.vertices.add(tr.u2)
            self.edges.add((tr.u1, tr.u2))

    def connected(self) -> bool:
        if not self.vertices:
            return True  # the empty pattern (root) is trivially relevant
        parent: Dict[int, int] = {v: v for v in self.vertices}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for u, v in self.edges:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
        roots = {find(v) for v in self.vertices}
        return len(roots) <= 1


def union_graph(trs: Iterable[TR]) -> UnionGraph:
    g = UnionGraph()
    for tr in trs:
        g.add_tr(tr)
    return g


def pattern_union_graph(p: Pattern) -> UnionGraph:
    g = UnionGraph()
    for itemset in p:
        for tr in itemset:
            g.add_tr(tr)
    return g


def is_relevant(p: Pattern) -> bool:
    """Def 5/6: union graph connected (single vertex counts)."""
    return pattern_union_graph(p).connected()
