"""Canonical forms of transformation subsequences (Def 7).

A pattern's identity must be invariant under the renaming of its (pattern
local) vertex IDs: Def 4's mapping psi means two TR sequences that differ
only by an injective vertex relabeling denote the same pattern.  Def 7
defines the canonical representation as the minimal code over all
representations; we realize it as the lexicographically minimal encoding
over all bijective relabelings onto {0..n-1}.

Patterns mined in practice are small (a handful of vertices), so an exact
search over relabelings with early pruning is both simple and fast; an
LRU cache collapses repeated canonicalizations.
"""
from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Dict, Tuple

from .graphseq import Pattern, TR, pattern_vertices

Code = Tuple[Tuple[Tuple[int, int, int, int], ...], ...]


def _encode_tr(tr: TR, m: Dict[int, int]) -> Tuple[int, int, int, int]:
    if tr.is_vertex:
        return (int(tr.type), m[tr.u1], -1, tr.label)
    a, b = m[tr.u1], m[tr.u2]
    if a > b:
        a, b = b, a
    return (int(tr.type), a, b, tr.label)


def pattern_code(p: Pattern, mapping: Dict[int, int]) -> Code:
    return tuple(
        tuple(sorted(_encode_tr(tr, mapping) for tr in itemset))
        for itemset in p
    )


def relabel_pattern(p: Pattern, mapping: Dict[int, int]) -> Pattern:
    out = []
    for itemset in p:
        new = set()
        for tr in itemset:
            if tr.is_vertex:
                new.add(TR(tr.type, mapping[tr.u1], tr.u2, tr.label))
            else:
                a, b = mapping[tr.u1], mapping[tr.u2]
                if a > b:
                    a, b = b, a
                new.add(TR(tr.type, a, b, tr.label))
        out.append(frozenset(new))
    return tuple(out)


@lru_cache(maxsize=1 << 18)
def _canonical(p: Pattern) -> Tuple[Code, Tuple[Tuple[int, int], ...]]:
    vs = pattern_vertices(p)
    n = len(vs)
    if n == 0:
        return pattern_code(p, {}), ()
    best: Code | None = None
    best_m: Dict[int, int] = {}
    # Exact minimization.  Vertices are few; iterate bijections with an
    # early lexicographic cutoff per permutation.
    for perm in itertools.permutations(range(n)):
        m = {v: perm[i] for i, v in enumerate(vs)}
        code = pattern_code(p, m)
        if best is None or code < best:
            best, best_m = code, m
    return best, tuple(sorted(best_m.items()))  # type: ignore[return-value]


def canonical_code(p: Pattern) -> Code:
    return _canonical(p)[0]


def canonical_map(p: Pattern) -> Dict[int, int]:
    """The relabeling old-vid -> canonical-vid realizing the min code."""
    return dict(_canonical(p)[1])


def code_to_pattern(code: Code) -> Pattern:
    out = []
    for itemset in code:
        s = set()
        for t, a, b, lab in itemset:
            s.add(TR(TRType_from_int(t), a, b, lab))
        out.append(frozenset(s))
    return tuple(out)


def TRType_from_int(t: int):
    from .graphseq import TRType

    return TRType(t)


@lru_cache(maxsize=1 << 18)
def canonical_form(p: Pattern) -> Pattern:
    """Return the canonical representative of ``p`` (vertex IDs 0..n-1)."""
    return code_to_pattern(canonical_code(p))


def is_canonical(p: Pattern) -> bool:
    return canonical_form(p) == p
