"""The comparison that decides ``correct``.

Every number it returns is compared with its limit; all limits are 0,
since the configurations guarantee exact results (PERF.md gives the
readings each was set from).  The reference is the frozen host miner and
containment oracle under ``bench_port/reference``; it mines the DB again
itself and reads the system's outputs only to judge them.

* Mining: every job of the window is held to the reference's map:
  ``patterns_wrong`` is the most patterns any job got wrong (missing,
  extra, or at another support).
* Serving: ``bank_wrong`` holds the served bank (mined on the card in
  set-up) to the reference's map the same way; ``answers_missing`` counts
  queries of the window left without an answer; then a sample of the
  pool's sequences drawn from the seed (``kinds/query.py``):
  ``rows_wrong`` and ``topk_wrong`` count the answers the window gave
  them (joined or from the cache) whose contained set, or whose top-k
  list of ``(pattern, support)``, differs from the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..reference.canonical import canonical_code, canonical_form
from ..reference.containment import contains
from ..reference.graphseq import TR, TRType
from ..reference.reverse_search import mine_gtrace_rs


def check(name: str, value, limit) -> Dict:
    return {"name": name, "value": value, "limit": limit}


def to_reference(p):
    """A system's pattern in the reference's classes and canonical form."""
    return canonical_form(tuple(
        frozenset(TR(TRType(int(tr.type)), tr.u1, tr.u2, tr.label)
                  for tr in itemset) for itemset in p))


def map_diff(got: Dict, want: Dict) -> int:
    """Patterns missing from ``got``, extra in it, or at another support
    (two of its patterns with one canonical form count as wrong)."""
    ref = {}
    wrong = 0
    for p, s in got.items():
        q = to_reference(p)
        if q in ref:
            wrong += 1
        ref[q] = int(s)
    wrong += sum(1 for q in ref if q not in want)
    wrong += sum(1 for q, s in want.items() if ref.get(q) != s)
    return wrong


def reference_map(db, sigma: int, max_len: int) -> Dict:
    return mine_gtrace_rs(db, sigma, max_len=max_len).patterns


def check_mining(outputs: List[Dict], want: Dict) -> List[Dict]:
    worst = max((map_diff(got, want) for got in outputs), default=0)
    return [check("patterns_wrong", worst, 0)]


def check_serving(server, kept: Dict[int, list], missing: int,
                  pool: Sequence, want: Dict, k: int) -> List[Dict]:
    """``kept``: the answers the window gave to each sampled pool index;
    ``missing``: the queries it left without an answer."""
    rows = server.rows()
    checks = [check("bank_wrong", map_diff(dict(rows), want), 0),
              check("answers_missing", missing, 0)]
    row_pat = [to_reference(p) for p, _ in rows]
    ranked = sorted(want.items(), key=lambda ps: (-ps[1],
                                                  canonical_code(ps[0])))
    rows_wrong = topk_wrong = 0
    for i, answers in sorted(kept.items()):
        hit = [(p, s) for p, s in ranked if contains(p, pool[i])]
        want_set = {p for p, _ in hit}
        want_top = hit[:k]
        for a in answers:
            contained, topk = server.answer(a)
            got_set = {row_pat[j] for j, c in enumerate(contained) if c}
            rows_wrong += got_set != want_set
            got_top = [(row_pat[j], int(s)) for j, s in topk]
            topk_wrong += got_top != want_top
    checks.append(check("rows_wrong", rows_wrong, 0))
    checks.append(check("topk_wrong", topk_wrong, 0))
    return checks
