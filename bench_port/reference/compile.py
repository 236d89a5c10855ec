"""Compile graph sequences into transformation sequences (Defs 1-3).

The diff between two successive interstates is a minimal edit script;
because all vertices carry persistent IDs it is computable in linear time
(Sec. 2.1).  Within one intrastate sequence we order rules so that the
script is *applicable*: relabels first, then edge deletions, vertex
deletions, vertex insertions, edge insertions (an edge can only be deleted
before its endpoint disappears and inserted after both endpoints exist).

``encode_initial=True`` (default) prepends an empty interstate so the
construction of g(1) itself is part of the sequence; this matches the
worked examples in the paper (Figs. 7-8) where ``vi`` rules for the first
graph appear in the compiled data.
"""
from __future__ import annotations

from typing import List

from .graphseq import (
    LabeledGraph,
    GraphSequence,
    TR,
    TRSeq,
    TRType,
    edge_tr,
    vertex_tr,
)


def diff_graphs(g0: LabeledGraph, g1: LabeledGraph) -> List[TR]:
    """Minimal applicable edit script transforming ``g0`` into ``g1``."""
    trs: List[TR] = []
    # relabels
    for u in sorted(g0.vlabels.keys() & g1.vlabels.keys()):
        if g0.vlabels[u] != g1.vlabels[u]:
            trs.append(vertex_tr(TRType.VR, u, g1.vlabels[u]))
    for e in sorted(g0.elabels.keys() & g1.elabels.keys()):
        if g0.elabels[e] != g1.elabels[e]:
            trs.append(edge_tr(TRType.ER, e[0], e[1], g1.elabels[e]))
    # deletions (edges before vertices)
    for e in sorted(g0.elabels.keys() - g1.elabels.keys()):
        trs.append(edge_tr(TRType.ED, e[0], e[1]))
    for u in sorted(g0.vlabels.keys() - g1.vlabels.keys()):
        trs.append(vertex_tr(TRType.VD, u))
    # insertions (vertices before edges)
    for u in sorted(g1.vlabels.keys() - g0.vlabels.keys()):
        trs.append(vertex_tr(TRType.VI, u, g1.vlabels[u]))
    for e in sorted(g1.elabels.keys() - g0.elabels.keys()):
        trs.append(edge_tr(TRType.EI, e[0], e[1], g1.elabels[e]))
    return trs


def compile_sequence(d: GraphSequence, encode_initial: bool = True) -> TRSeq:
    """Graph sequence -> interstate transformation sequence (Def 3)."""
    graphs = list(d)
    if encode_initial:
        graphs = [LabeledGraph()] + graphs
    out = []
    for g0, g1 in zip(graphs, graphs[1:]):
        out.append(tuple(diff_graphs(g0, g1)))
    return tuple(out)


def apply_tr(g: LabeledGraph, tr: TR) -> None:
    """Apply one TR in place (validity-checked)."""
    if tr.type == TRType.VI:
        assert tr.u1 not in g.vlabels, f"vi on existing vertex {tr.u1}"
        g.add_vertex(tr.u1, tr.label)
    elif tr.type == TRType.VD:
        g.remove_vertex(tr.u1)
    elif tr.type == TRType.VR:
        assert tr.u1 in g.vlabels
        g.vlabels[tr.u1] = tr.label
    elif tr.type == TRType.EI:
        assert (tr.u1, tr.u2) not in g.elabels
        g.add_edge(tr.u1, tr.u2, tr.label)
    elif tr.type == TRType.ED:
        g.remove_edge(tr.u1, tr.u2)
    elif tr.type == TRType.ER:
        assert (tr.u1, tr.u2) in g.elabels
        g.elabels[(tr.u1, tr.u2)] = tr.label
    else:  # pragma: no cover
        raise ValueError(tr)


def reconstruct(s: TRSeq, initial: LabeledGraph | None = None) -> GraphSequence:
    """Replay a transformation sequence into the graph sequence it encodes."""
    g = (initial or LabeledGraph()).copy()
    out: GraphSequence = []
    for itemset in s:
        for tr in itemset:
            apply_tr(g, tr)
        out.append(g.copy())
    return out
