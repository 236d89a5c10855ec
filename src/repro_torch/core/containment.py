"""Containment oracle (Def 4) by explicit backtracking.

``s_p [= s_d`` iff there are injective maps phi (strictly increasing over
intrastate indices) and psi (over vertex IDs) such that every pattern TR
has a matching data TR of the same type and label in the mapped intrastate
with psi-mapped operands.

This is the reference implementation used by tests and by the host-side
fallback engine; the scalable path lives in ``repro_torch.mining`` and must agree
with this oracle exactly (property-tested).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from .graphseq import Pattern, TR, TRSeq

Embedding = Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...]]
# (phi: data itemset index per pattern itemset, psi: sorted (pat_v, dat_v))


def _match_itemset(
    pat_trs: List[TR],
    data_trs: Tuple[TR, ...],
    psi: Dict[int, int],
    used: set,
) -> Iterator[Dict[int, int]]:
    """Yield extensions of psi matching all ``pat_trs`` into ``data_trs``."""
    if not pat_trs:
        yield dict(psi)
        return
    # most-constrained-first: prefer TRs whose vertices are already mapped
    pat_trs = sorted(
        pat_trs, key=lambda t: sum(v not in psi for v in t.vertices())
    )
    tr = pat_trs[0]
    rest = pat_trs[1:]
    for dtr in data_trs:
        if dtr.type != tr.type or dtr.label != tr.label:
            continue
        if tr.is_vertex:
            cands = [((tr.u1, dtr.u1),)]
        else:
            cands = [
                ((tr.u1, dtr.u1), (tr.u2, dtr.u2)),
                ((tr.u1, dtr.u2), (tr.u2, dtr.u1)),
            ]
        for pairs in cands:
            add: Dict[int, int] = {}
            ok = True
            for pv, dv in pairs:
                cur = psi.get(pv, add.get(pv))
                if cur is not None:
                    if cur != dv:
                        ok = False
                        break
                elif dv in used or dv in add.values():
                    ok = False
                    break
                else:
                    add[pv] = dv
            if not ok:
                continue
            psi.update(add)
            used.update(add.values())
            yield from _match_itemset(rest, data_trs, psi, used)
            for k in add:
                del psi[k]
                used.discard(add[k])


def iter_embeddings(p: Pattern, s: TRSeq) -> Iterator[Embedding]:
    """All embeddings of pattern ``p`` in data sequence ``s``."""
    n = len(p)

    def rec(pi: int, start: int, psi: Dict[int, int], used: set,
            phi: List[int]) -> Iterator[Embedding]:
        if pi == n:
            yield (tuple(phi), tuple(sorted(psi.items())))
            return
        for di in range(start, len(s)):
            for new_psi in _match_itemset(list(p[pi]), s[di], psi, used):
                phi.append(di)
                yield from rec(
                    pi + 1, di + 1, new_psi,
                    set(new_psi.values()), phi,
                )
                phi.pop()

    yield from rec(0, 0, {}, set(), [])


def contains(p: Pattern, s: TRSeq) -> bool:
    for _ in iter_embeddings(p, s):
        return True
    return False


def support(p: Pattern, db: List[TRSeq]) -> int:
    return sum(1 for s in db if contains(p, s))
