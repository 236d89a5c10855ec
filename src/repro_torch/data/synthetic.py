"""Synthetic graph-sequence generators.

* ``generate_table3_db`` reproduces the artificial-dataset generator of
  the paper's Sec. 5.1 / Table 3: graph sequences grown by per-interstate
  insert/delete/relabel operations (probabilities p_i / p_d / 1-p_i-p_d),
  grown until relevant, then overlaid with N embedded rFTS patterns with
  probability 1/N each.
* ``generate_enron_like_db`` mimics the Enron weekly-communication data of
  Sec. 5.2: |V| persons with role labels, n daily interstates per week,
  gradually-changing communication edges labeled by mail volume.
* ``random_graph_sequence`` is the small fuzzer used by property tests.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Tuple

from ..core.compile import compile_sequence
from ..core.graphseq import (
    LabeledGraph,
    Pattern,
    TR,
    TRSeq,
    TRType,
    edge_tr,
    pattern_from_lists,
    vertex_tr,
)
from ..core.union_graph import is_relevant


def _mutate(g: LabeledGraph, rng: random.Random, p_i: float, p_d: float,
            n_v: int, n_vl: int, n_el: int, p_e: float) -> None:
    """One Table-3 style mutation: insert / delete / relabel."""
    r = rng.random()
    vs = sorted(g.vlabels)
    if r < p_i or not vs:
        # insertion: a vertex (with edges to existing per p_e) or an edge
        if rng.random() < 0.5 or len(vs) < 2:
            u = 0
            while u in g.vlabels:
                u += 1
            if u >= n_v:
                return
            g.add_vertex(u, rng.randrange(n_vl))
            for v in vs:
                if rng.random() < p_e:
                    g.add_edge(u, v, rng.randrange(n_el))
        else:
            u, v = rng.sample(vs, 2)
            e = (min(u, v), max(u, v))
            if e not in g.elabels:
                g.add_edge(u, v, rng.randrange(n_el))
    elif r < p_i + p_d:
        # deletion: an edge, or an isolated vertex
        if g.elabels and rng.random() < 0.7:
            e = rng.choice(sorted(g.elabels))
            g.remove_edge(*e)
        else:
            iso = [u for u in g.vlabels if not g.incident(u)]
            if iso:
                g.remove_vertex(rng.choice(iso))
    else:
        # relabeling
        if g.elabels and rng.random() < 0.5:
            e = rng.choice(sorted(g.elabels))
            g.elabels[e] = rng.randrange(n_el)
        elif vs:
            u = rng.choice(vs)
            g.vlabels[u] = rng.randrange(n_vl)


def random_graph_sequence(
    rng: random.Random,
    n_steps: int = 4,
    n_v: int = 4,
    n_vl: int = 2,
    n_el: int = 2,
    p_i: float = 0.6,
    p_d: float = 0.2,
    p_e: float = 0.3,
    muts_per_step: Tuple[int, int] = (1, 2),
) -> List[LabeledGraph]:
    g = LabeledGraph()
    seq = []
    for _ in range(n_steps):
        for _ in range(rng.randint(*muts_per_step)):
            _mutate(g, rng, p_i, p_d, n_v, n_vl, n_el, p_e)
        seq.append(g.copy())
    return seq


@dataclasses.dataclass
class Table3Params:
    """Default values of Table 3 (scaled down by callers as needed)."""

    p_i: float = 0.80
    p_d: float = 0.10
    v_avg: int = 6
    v_avg_pattern: int = 3
    n_vlabels: int = 5
    n_elabels: int = 5
    n_patterns: int = 10
    db_size: int = 1000
    p_e: float = 0.15
    d_ist: int = 2
    n_interstates: int = 5


def _grow_sequence(rng: random.Random, p: Table3Params,
                   n_v: int) -> List[LabeledGraph]:
    """Start from |V|/2 vertices w/ edge prob p_e, mutate d_ist times per
    interstate, continue until the compiled sequence is relevant."""
    g = LabeledGraph()
    for u in range(max(1, n_v // 2)):
        g.add_vertex(u, rng.randrange(p.n_vlabels))
    vs = sorted(g.vlabels)
    for i in range(len(vs)):
        for j in range(i + 1, len(vs)):
            if rng.random() < p.p_e:
                g.add_edge(vs[i], vs[j], rng.randrange(p.n_elabels))
    seq = [g.copy()]
    for _ in range(p.n_interstates - 1):
        for _ in range(p.d_ist):
            _mutate(g, rng, p.p_i, p.p_d, n_v, p.n_vlabels, p.n_elabels,
                    p.p_e)
        seq.append(g.copy())
    return seq


def _overlay(s: TRSeq, pattern: Pattern, rng: random.Random,
             vertex_base: int) -> TRSeq:
    """Inject a pattern's TRs into a compiled sequence (fresh vertex IDs,
    random strictly-increasing itemset positions)."""
    n = len(s)
    if n < len(pattern):
        return s
    positions = sorted(rng.sample(range(n), len(pattern)))
    vmap = {}
    out = [list(itemset) for itemset in s]
    for pos, itemset in zip(positions, pattern):
        for tr in sorted(itemset):
            for v in tr.vertices():
                if v not in vmap:
                    vmap[v] = vertex_base + len(vmap)
            if tr.is_vertex:
                ntr = TR(tr.type, vmap[tr.u1], tr.u2, tr.label)
            else:
                a, b = vmap[tr.u1], vmap[tr.u2]
                ntr = TR(tr.type, min(a, b), max(a, b), tr.label)
            if ntr not in out[pos]:
                out[pos].append(ntr)
    return tuple(tuple(x) for x in out)


def generate_pattern(rng: random.Random, p: Table3Params) -> Pattern:
    """A small relevant pattern (the paper's embedded rFTS)."""
    while True:
        seq = random_graph_sequence(
            rng, n_steps=rng.randint(2, 3), n_v=p.v_avg_pattern,
            n_vl=p.n_vlabels, n_el=p.n_elabels, p_i=0.85, p_d=0.05,
            p_e=0.5,
        )
        s = compile_sequence(seq)
        pat = pattern_from_lists([it for it in s if it])
        if pat and is_relevant(pat) and sum(len(i) for i in pat) >= 2:
            return pat


def generate_table3_db(
    params: Table3Params | None = None, seed: int = 0
) -> List[TRSeq]:
    p = params or Table3Params()
    rng = random.Random(seed)
    patterns = [generate_pattern(rng, p) for _ in range(p.n_patterns)]
    db: List[TRSeq] = []
    for _ in range(p.db_size):
        seq = _grow_sequence(rng, p, p.v_avg)
        s = compile_sequence(seq)
        for pat in patterns:
            if rng.random() < 1.0 / p.n_patterns:
                s = _overlay(s, pat, rng, vertex_base=1000)
        db.append(s)
    return db


def generate_enron_like_db(
    n_weeks: int = 123,
    n_persons: int = 30,
    n_interstates: int = 7,
    n_roles: int = 8,
    n_volumes: int = 5,
    p_edge_on: float = 0.05,
    p_edge_off: float = 0.5,
    seed: int = 0,
) -> List[TRSeq]:
    """Weekly graph sequences of daily communication graphs (Sec. 5.2)."""
    rng = random.Random(seed)
    roles = {u: rng.randrange(n_roles) for u in range(n_persons)}
    db: List[TRSeq] = []
    for _ in range(n_weeks):
        g = LabeledGraph()
        seq = []
        for _day in range(n_interstates):
            # edges toggle gradually day to day
            for e in sorted(g.elabels):
                if rng.random() < p_edge_off:
                    g.remove_edge(*e)
            n_new = rng.randint(1, max(2, int(n_persons * p_edge_on)))
            for _ in range(n_new):
                u, v = rng.sample(range(n_persons), 2)
                for w in (u, v):
                    if w not in g.vlabels:
                        g.add_vertex(w, roles[w])
                e = (min(u, v), max(u, v))
                if e not in g.elabels:
                    g.add_edge(u, v, rng.randrange(n_volumes))
            # drop now-isolated persons
            for u in sorted(g.vlabels):
                if not g.incident(u):
                    g.remove_vertex(u)
            seq.append(g.copy())
        db.append(compile_sequence(seq))
    return db
