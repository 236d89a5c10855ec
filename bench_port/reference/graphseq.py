"""Graph-sequence and transformation-rule (TR) data model.

Implements the representation layer of GTRACE / GTRACE-RS (Inokuchi,
Ikuta & Washio 2011), Defs 1-3 and Table 2:

* a labeled graph ``g = (V, E, L, f)`` with globally persistent vertex IDs,
* a graph sequence ``d = <g(1) ... g(n)>``,
* six transformation rules (vi, vd, vr, ei, ed, er) describing the minimal
  edit script between successive interstates,
* transformation sequences as *sequences of itemsets* of TRs.  Within an
  intrastate the order of TRs is irrelevant for containment (Def 4 only
  requires existence of a matching TR in the mapped intrastate), which is
  exactly why the paper converts intrastates to itemsets in Sec. 4.3.  We
  therefore treat the intrastate index ``j`` as the itemset index and drop
  ``k`` from pattern identity.

Labels are small non-negative ints.  ``NO_LABEL`` (the paper's bullet) is
used by deletions.
"""
from __future__ import annotations

import enum
from typing import Dict, FrozenSet, Iterable, List, NamedTuple, Tuple

NO_LABEL = -1
NO_VERTEX = -1


class TRType(enum.IntEnum):
    """The six transformation-rule types of Table 2."""

    VI = 0  # vertex insertion
    VD = 1  # vertex deletion
    VR = 2  # vertex relabeling
    EI = 3  # edge insertion
    ED = 4  # edge deletion
    ER = 5  # edge relabeling


VERTEX_TR_TYPES = frozenset({TRType.VI, TRType.VD, TRType.VR})
EDGE_TR_TYPES = frozenset({TRType.EI, TRType.ED, TRType.ER})


class TR(NamedTuple):
    """One transformation rule.

    ``u2 == NO_VERTEX`` for vertex rules; ``label == NO_LABEL`` for
    deletions.  Edge endpoints are stored with ``u1 < u2`` (undirected).
    """

    type: TRType
    u1: int
    u2: int
    label: int

    @property
    def is_vertex(self) -> bool:
        return self.type in VERTEX_TR_TYPES

    @property
    def is_edge(self) -> bool:
        return self.type in EDGE_TR_TYPES

    @property
    def edge(self) -> Tuple[int, int]:
        return (self.u1, self.u2)

    def vertices(self) -> Tuple[int, ...]:
        if self.is_vertex:
            return (self.u1,)
        return (self.u1, self.u2)

    def short(self) -> str:
        names = ["vi", "vd", "vr", "ei", "ed", "er"]
        lab = "." if self.label == NO_LABEL else str(self.label)
        if self.is_vertex:
            return f"{names[self.type]}[{self.u1},{lab}]"
        return f"{names[self.type]}[({self.u1},{self.u2}),{lab}]"


def vertex_tr(type_: TRType, u: int, label: int = NO_LABEL) -> TR:
    assert type_ in VERTEX_TR_TYPES
    if type_ == TRType.VD:
        label = NO_LABEL
    return TR(type_, u, NO_VERTEX, label)


def edge_tr(type_: TRType, u1: int, u2: int, label: int = NO_LABEL) -> TR:
    assert type_ in EDGE_TR_TYPES and u1 != u2
    if type_ == TRType.ED:
        label = NO_LABEL
    if u1 > u2:
        u1, u2 = u2, u1
    return TR(type_, u1, u2, label)


# An itemset of TRs (one intrastate transformation sequence, order dropped).
Itemset = FrozenSet[TR]
# A pattern: sequence of non-empty itemsets, vertex IDs pattern-local.
Pattern = Tuple[Itemset, ...]
# A data transformation sequence: itemsets may be empty (unchanged steps).
TRSeq = Tuple[Tuple[TR, ...], ...]

EMPTY_PATTERN: Pattern = ()


def pattern_from_lists(itemsets: Iterable[Iterable[TR]]) -> Pattern:
    return tuple(frozenset(s) for s in itemsets)


def pattern_length(p: Pattern) -> int:
    """Number of TRs (the paper's sequence length)."""
    return sum(len(s) for s in p)


def pattern_vertices(p: Pattern) -> Tuple[int, ...]:
    vs = set()
    for itemset in p:
        for tr in itemset:
            vs.update(tr.vertices())
    return tuple(sorted(vs))


def pattern_str(p: Pattern) -> str:
    return " | ".join(
        " ".join(tr.short() for tr in sorted(s)) for s in p
    ) or "<empty>"


class LabeledGraph:
    """Labeled undirected graph with persistent vertex IDs."""

    __slots__ = ("vlabels", "elabels")

    def __init__(
        self,
        vlabels: Dict[int, int] | None = None,
        elabels: Dict[Tuple[int, int], int] | None = None,
    ):
        self.vlabels: Dict[int, int] = dict(vlabels or {})
        self.elabels: Dict[Tuple[int, int], int] = {}
        for (u, v), l in (elabels or {}).items():
            self.add_edge(u, v, l)

    def add_vertex(self, u: int, label: int) -> None:
        self.vlabels[u] = label

    def add_edge(self, u: int, v: int, label: int) -> None:
        assert u != v
        if u > v:
            u, v = v, u
        assert u in self.vlabels and v in self.vlabels, (u, v, self.vlabels)
        self.elabels[(u, v)] = label

    def remove_edge(self, u: int, v: int) -> None:
        if u > v:
            u, v = v, u
        del self.elabels[(u, v)]

    def remove_vertex(self, u: int) -> None:
        assert not self.incident(u), f"vertex {u} is not isolated"
        del self.vlabels[u]

    def incident(self, u: int) -> List[Tuple[int, int]]:
        return [e for e in self.elabels if u in e]

    def copy(self) -> "LabeledGraph":
        g = LabeledGraph()
        g.vlabels = dict(self.vlabels)
        g.elabels = dict(self.elabels)
        return g

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, LabeledGraph)
            and self.vlabels == other.vlabels
            and self.elabels == other.elabels
        )

    def __repr__(self) -> str:
        return f"LabeledGraph(V={self.vlabels}, E={self.elabels})"


GraphSequence = List[LabeledGraph]


# A pattern as nested tuples of plain ints: itemsets in order, each a
# sorted tuple of (type, u1, u2, label) rows.
PatternKey = Tuple[Tuple[Tuple[int, int, int, int], ...], ...]


def pattern_key(p) -> PatternKey:
    """``p`` as nested tuples of plain ints.

    Works on a pattern from any package that models a TR as a
    ``(type, u1, u2, label)`` 4-tuple, so two packages' mining results
    can be compared as ``{pattern_key(p): support}`` maps without relying
    on their ``TRType``/``TR`` classes comparing equal.
    """
    return tuple(
        tuple(sorted((int(t), int(u1), int(u2), int(lab))
                     for t, u1, u2, lab in itemset))
        for itemset in p
    )


def db_from_reference(db) -> List[TRSeq]:
    """Rebuild a DB of ``(type, u1, u2, label)`` TR rows (for example one
    generated by another package) in this package's ``TR``/``TRType``.
    Reads plain values only, so it imports nothing of the source
    package."""
    return [
        tuple(
            tuple(TR(TRType(int(t)), int(u1), int(u2), int(lab))
                  for t, u1, u2, lab in itemset)
            for itemset in seq
        )
        for seq in db
    ]
