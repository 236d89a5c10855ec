"""Pattern bank: a ``MiningResult`` compiled for query-time containment.

Each mined rFTS becomes a fixed-shape *step program*: its canonical
itemsets in order, TRs sorted within each itemset, one int32 row per TR.
Replaying the program against a data sequence with the embedding join
(serving.batch) grows exactly the prefix embeddings the host
oracle backtracks over, so "frontier non-empty after the last step" is
the Def-4 containment test.

Step row layout (``STEP_FIELDS`` columns, int32):
  0 type, 1 pu1, 2 pu2 (0 for vertex TRs), 3 label,
  4 new_itemset (1 = first TR of its itemset), 5 itemset index,
  6 step_valid (0 = padding row),
  7 token key = type * n_label_keys + label + 1 (the inverted-index
    bucket the step's candidate tokens live in, see batch.py)

Banks also carry per-pattern metadata rows (support, #steps, #itemsets,
#vertices, valid flag) used for top-k scoring and shard-by-pattern
serving (see sharded.py), plus the per-pattern token-key requirement
counts ``req`` [P, 6*n_label_keys] that drive the server's
necessary-condition prescreen: psi injectivity + strictly increasing phi
force distinct pattern TRs onto distinct data tokens, so a sequence can
only contain a pattern if it has at least ``req[p, k]`` tokens of every
key k.
"""
from __future__ import annotations

import array
import dataclasses
import functools
import hashlib
import itertools
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np

from ..core.canonical import canonical_code, canonical_form
from ..core.graphseq import (
    Pattern,
    TRSeq,
    db_from_reference,
    pattern_key,
    pattern_length,
    pattern_vertices,
)
from ..core.gtrace import MiningResult

STEP_FIELDS = 8


@dataclasses.dataclass
class PatternBank:
    steps: np.ndarray          # [P, L, STEP_FIELDS] int32
    support: np.ndarray        # [P] int32 (0 on padding rows)
    n_steps: np.ndarray        # [P] int32
    n_itemsets: np.ndarray     # [P] int32
    n_vertices: np.ndarray     # [P] int32
    pattern_valid: np.ndarray  # [P] int32 (0 = padding row)
    req: np.ndarray            # [P, 6*n_label_keys] int32 prescreen rows
    patterns: List[Pattern]    # the n_patterns real patterns, bank order
    nv: int                    # max vertices over the bank (psi width)
    n_label_keys: int          # label slots per TR type (max label + 2)

    @property
    def n_patterns(self) -> int:
        return len(self.patterns)

    @property
    def n_rows(self) -> int:
        return self.steps.shape[0]

    @property
    def max_steps(self) -> int:
        return self.steps.shape[1]

    def shard(self, n_shards: int) -> List["PatternBank"]:
        """Split by pattern rows into ``n_shards`` equal banks (row count
        must divide; use ``pad_patterns_to`` at compile time)."""
        P = self.n_rows
        assert P % n_shards == 0, (P, n_shards)
        loc = P // n_shards
        out = []
        for i in range(n_shards):
            sl = slice(i * loc, (i + 1) * loc)
            n_real = int(self.pattern_valid[sl].sum())
            out.append(PatternBank(
                steps=self.steps[sl],
                support=self.support[sl],
                n_steps=self.n_steps[sl],
                n_itemsets=self.n_itemsets[sl],
                n_vertices=self.n_vertices[sl],
                pattern_valid=self.pattern_valid[sl],
                req=self.req[sl],
                patterns=self.patterns[i * loc : i * loc + n_real],
                nv=self.nv,
                n_label_keys=self.n_label_keys,
            ))
        return out


def pattern_steps(
    p: Pattern, n_label_keys: int
) -> List[Tuple[int, ...]]:
    """The step program of one canonical pattern."""
    rows = []
    for i, itemset in enumerate(p):
        for t_i, tr in enumerate(sorted(itemset)):
            pu2 = 0 if tr.is_vertex else tr.u2
            key = int(tr.type) * n_label_keys + tr.label + 1
            rows.append((int(tr.type), tr.u1, pu2, tr.label,
                         int(t_i == 0), i, 1, key))
    return rows


def compile_bank(
    result: Union[MiningResult, Mapping[Pattern, int]],
    *,
    max_steps: int | None = None,
    pad_patterns_to: int | None = None,
    min_support: int = 0,
    top: int | None = None,
) -> PatternBank:
    """Pack mined patterns (canonicalized) into a PatternBank.

    Patterns are ordered by (-support, canonical code) so the bank layout
    is deterministic; ``top`` keeps only the strongest patterns and
    ``pad_patterns_to`` rounds the row count up (padding rows have
    ``pattern_valid=0`` and never report containment).
    """
    items = result.patterns if isinstance(result, MiningResult) else result
    chosen = [
        (canonical_form(p), int(s))
        for p, s in items.items()
        if len(p) > 0 and s >= min_support
    ]
    chosen.sort(key=lambda ps: (-ps[1], canonical_code(ps[0])))
    if top is not None:
        chosen = chosen[:top]
    patterns = [p for p, _ in chosen]
    max_label = max(
        (tr.label for p in patterns for s in p for tr in s), default=-1
    )
    n_label_keys = max_label + 2  # labels -1..max_label
    progs = [pattern_steps(p, n_label_keys) for p in patterns]
    L = max((len(r) for r in progs), default=1)
    if max_steps is not None:
        assert max_steps >= L, (max_steps, L)
        L = max_steps
    P = len(patterns)
    rows = P
    if pad_patterns_to is not None:
        assert pad_patterns_to >= P, (pad_patterns_to, P)
        rows = pad_patterns_to
    rows = max(rows, 1)
    steps = np.zeros((rows, max(L, 1), STEP_FIELDS), dtype=np.int32)
    for pi, prog in enumerate(progs):
        for si, row in enumerate(prog):
            steps[pi, si] = row
    meta = {
        "support": [s for _, s in chosen],
        "n_steps": [len(r) for r in progs],
        "n_itemsets": [len(p) for p in patterns],
        "n_vertices": [len(pattern_vertices(p)) for p in patterns],
        "pattern_valid": [1] * P,
    }
    pad = rows - P
    arrays = {
        k: np.array(v + [0] * pad, dtype=np.int32) for k, v in meta.items()
    }
    req = np.zeros((rows, 6 * n_label_keys), dtype=np.int32)
    for pi, prog in enumerate(progs):
        for row in prog:
            req[pi, row[7]] += 1
    nv = int(arrays["n_vertices"].max(initial=0))
    assert all(pattern_length(p) <= steps.shape[1] for p in patterns)
    return PatternBank(steps=steps, patterns=patterns, nv=max(nv, 1),
                       req=req, n_label_keys=n_label_keys, **arrays)


class BankCapacityError(ValueError):
    """An incremental bank extension does not fit the compiled capacity
    (label space / vertex width).  Callers fall back to a full
    ``compile_bank`` recompile - the streaming layer's exactness escape
    hatch."""


def slice_bank(bank: PatternBank, rows: Sequence[int]) -> PatternBank:
    """A flat sub-bank over the given pattern rows (no padding rows;
    global ``nv``/``n_label_keys`` preserved so token keys and psi
    widths stay consistent with the parent bank)."""
    idx = np.asarray(list(rows), np.int64)
    if len(idx) == 0:
        empty = compile_bank({})
        return PatternBank(
            steps=np.zeros((1, bank.max_steps, STEP_FIELDS), np.int32),
            support=empty.support, n_steps=empty.n_steps,
            n_itemsets=empty.n_itemsets, n_vertices=empty.n_vertices,
            pattern_valid=empty.pattern_valid,
            req=np.zeros((1, bank.req.shape[1]), np.int32),
            patterns=[], nv=bank.nv, n_label_keys=bank.n_label_keys,
        )
    return PatternBank(
        steps=bank.steps[idx],
        support=bank.support[idx],
        n_steps=bank.n_steps[idx],
        n_itemsets=bank.n_itemsets[idx],
        n_vertices=bank.n_vertices[idx],
        pattern_valid=bank.pattern_valid[idx],
        req=bank.req[idx],
        patterns=[bank.patterns[i] for i in idx],
        nv=bank.nv,
        n_label_keys=bank.n_label_keys,
    )


def extend_bank(
    bank: PatternBank, new: Mapping[Pattern, int]
) -> PatternBank:
    """Append new patterns (canonicalized, ordered by (-support, code)
    for determinism) to a compiled bank without recompiling the existing
    rows: old row indices - and therefore window bitmaps, support
    arrays, and trie terminals over them - stay valid.

    The bank-wide support ordering invariant is *not* maintained across
    the append (streamed supports drift anyway); streaming callers score
    from their live support array.  Raises ``BankCapacityError`` when a
    new pattern needs a label outside the compiled ``n_label_keys``
    space (token keys would change for every existing row - that is a
    full recompile).  ``max_steps`` and ``nv`` grow as needed (padding
    columns only; existing rows are unchanged)."""
    items = [(canonical_form(p), int(s)) for p, s in new.items()]
    items.sort(key=lambda ps: (-ps[1], canonical_code(ps[0])))
    if not items:
        return bank
    max_label = max(
        (tr.label for p, _ in items for s in p for tr in s), default=-1
    )
    if max_label + 2 > bank.n_label_keys:
        raise BankCapacityError(
            f"label {max_label} outside compiled key space "
            f"(n_label_keys={bank.n_label_keys})"
        )
    progs = [pattern_steps(p, bank.n_label_keys) for p, _ in items]
    L = max(bank.max_steps, max(len(r) for r in progs))
    P_old, P_new = bank.n_rows, len(items)
    assert P_old == bank.n_patterns, \
        "extend_bank requires an unpadded bank"
    steps = np.zeros((P_old + P_new, L, STEP_FIELDS), np.int32)
    steps[:P_old, : bank.max_steps] = bank.steps
    for pi, prog in enumerate(progs):
        for si, row in enumerate(prog):
            steps[P_old + pi, si] = row
    req = np.zeros((P_old + P_new, bank.req.shape[1]), np.int32)
    req[:P_old] = bank.req
    for pi, prog in enumerate(progs):
        for row in prog:
            req[P_old + pi, row[7]] += 1
    cat = lambda old, vals: np.concatenate(  # noqa: E731
        [old, np.asarray(vals, np.int32)]
    )
    n_vertices = [len(pattern_vertices(p)) for p, _ in items]
    return PatternBank(
        steps=steps,
        support=cat(bank.support, [s for _, s in items]),
        n_steps=cat(bank.n_steps, [len(r) for r in progs]),
        n_itemsets=cat(bank.n_itemsets, [len(p) for p, _ in items]),
        n_vertices=cat(bank.n_vertices, n_vertices),
        pattern_valid=cat(bank.pattern_valid, [1] * P_new),
        req=req,
        patterns=bank.patterns + [p for p, _ in items],
        nv=max(bank.nv, max(n_vertices, default=1)),
        n_label_keys=bank.n_label_keys,
    )


def _relabeled_bytes(s: TRSeq, m: Dict[int, int]) -> bytes:
    """The canonical byte encoding of ``s`` under vertex relabeling
    ``m``: TRs sorted within each itemset after relabeling (edge
    endpoints reordered), empty itemsets dropped - they can never host
    a pattern itemset, so containment is invariant either way.  The
    encoding reconstructs the relabeled sequence (4 int64 fields per
    TR, a -9 separator per itemset; every field is >= -1), so equal
    bytes certify a vertex bijection between the underlying sequences.
    """
    out: List[int] = []
    for itemset in s:
        if not itemset:
            continue
        rows = []
        for tr in itemset:
            if tr.type <= 2:  # vertex TR
                rows.append((int(tr.type), m[tr.u1], -1, tr.label))
            else:
                a, b = m[tr.u1], m[tr.u2]
                if a > b:
                    a, b = b, a
                rows.append((int(tr.type), a, b, tr.label))
        rows.sort()
        for row in rows:
            out.extend(row)
        out.append(-9)
    # array.array beats np.asarray by ~10x on these ~100-int lists
    return array.array("q", out).tobytes()


def canonical_sequence_map(
    s: TRSeq, max_candidates: int = 5040
) -> Dict[int, int]:
    """A canonical vertex relabeling of a data sequence, invariant under
    vertex bijections: containment (Def 4) only sees vertex identity
    through psi, so two sequences differing by a bijective renaming have
    identical containment rows - canonical cache keys make them hit the
    same server LRU entry.

    Vertices are partitioned by iterated signature refinement (a
    temporal Weisfeiler-Leman over TR occurrences: each round folds in
    the refined classes of the vertices each TR connects to) and
    ordered by final class; remaining ties are resolved *exactly* by
    minimizing the encoded bytes over the product of within-class
    permutations.  If that product exceeds ``max_candidates``
    (pathologically symmetric inputs) we fall back to raw-id order -
    the key is then no longer renaming-invariant but stays *sound*:
    any relabeled encoding equal between two sequences certifies they
    are bijective renamings of each other, so a cache hit never serves
    a wrong row."""
    # per-vertex occurrence lists, split into the color-independent
    # part (vertex TRs: computed once) and the part folding in the
    # refined class of the opposite endpoint (edge TRs: re-keyed each
    # round)
    vfix: Dict[int, List[Tuple[int, int, int]]] = {}
    edyn: Dict[int, List[Tuple[int, int, int, int]]] = {}

    def slot(v: int) -> Tuple[list, list]:
        f = vfix.get(v)
        if f is None:
            vfix[v] = f = []
            edyn[v] = []
        return f, edyn[v]

    j = 0
    for itemset in s:
        if not itemset:
            continue
        for tr in itemset:
            if tr.type <= 2:  # vertex TR
                slot(tr.u1)[0].append((j, int(tr.type), tr.label))
            else:
                row = (j, int(tr.type), tr.label)
                slot(tr.u1)[1].append(row + (tr.u2,))
                slot(tr.u2)[1].append(row + (tr.u1,))
        j += 1
    vs = sorted(vfix)
    if not vs:
        return {}
    n = len(vs)
    vid = {v: i for i, v in enumerate(vs)}
    static = [tuple(sorted(vfix[v])) for v in vs]
    dyn = [
        [(j, t, lab, vid[o]) for (j, t, lab, o) in edyn[v]] for v in vs
    ]
    color = [0] * n
    for _ in range(n):
        sig = [
            (color[i], static[i],
             tuple(sorted(
                 (j, t, lab, color[o]) for (j, t, lab, o) in dyn[i]
             )))
            for i in range(n)
        ]
        uniq = sorted(set(sig))
        ranks = {sg: r for r, sg in enumerate(uniq)}
        new = [ranks[sg] for sg in sig]
        if len(uniq) == n:  # discrete: nothing left to refine
            color = new
            break
        if new == color:
            break
        color = new
    classes: Dict[int, List[int]] = {}
    for i, c in enumerate(color):
        classes.setdefault(c, []).append(vs[i])
    ordered = [sorted(classes[c]) for c in sorted(classes)]
    if all(len(c) == 1 for c in ordered):
        return {c[0]: i for i, c in enumerate(ordered)}
    n_cand = 1
    for c in ordered:
        n_cand *= functools.reduce(lambda a, b: a * b,
                                   range(1, len(c) + 1), 1)
        if n_cand > max_candidates:
            return {v: i for i, v in enumerate(vs)}  # sound fallback
    best_bytes = None
    best_m: Dict[int, int] = {}
    for perms in itertools.product(
        *(itertools.permutations(c) for c in ordered)
    ):
        m: Dict[int, int] = {}
        i = 0
        for perm in perms:
            for v in perm:
                m[v] = i
                i += 1
        enc = _relabeled_bytes(s, m)
        if best_bytes is None or enc < best_bytes:
            best_bytes, best_m = enc, m
    return best_m


@functools.lru_cache(maxsize=1 << 12)
def sequence_fingerprint(s: TRSeq, canonical: bool = True) -> str:
    """Cache key for a data sequence: blake2b over the canonical byte
    encoding under ``canonical_sequence_map`` - invariant under vertex
    bijections (equal rows served from one LRU entry) and sound (equal
    fingerprints only for sequences with identical containment rows).
    ``canonical=False`` keys on raw vertex IDs (the pre-trie behavior;
    still sound, lower hit rate).

    The memo is a process-global LRU that retains its keyed sequences
    (canonicalization costs ~0.1ms/seq, so replays of hot queries skip
    it); its 4096 entries bound that retention independently of any
    ``PatternServer.cache_size``, and ``sequence_fingerprint
    .cache_clear()`` drops it (cold-path benchmarks do this alongside
    the server's row cache)."""
    if canonical:
        m = canonical_sequence_map(s)
    else:
        m = {}
        for itemset in s:
            for tr in itemset:
                for v in tr.vertices():
                    m.setdefault(v, v)
    h = hashlib.blake2b(digest_size=16)
    h.update(_relabeled_bytes(s, m))
    return h.hexdigest()


def bank_from_reference(ref_bank) -> PatternBank:
    """Rebuild a bank compiled by another package (read through its
    attributes: the arrays, ``patterns``, ``nv``, ``n_label_keys``) as
    this package's ``PatternBank``: the arrays are copied, the patterns
    rebuilt in this package's ``TR``/``TRType``.  Imports nothing of the
    source package, so two servers can serve the very same bank."""
    def pattern(p) -> Pattern:
        (seq,) = db_from_reference([pattern_key(p)])
        return tuple(frozenset(itemset) for itemset in seq)

    arrays = {
        k: np.array(getattr(ref_bank, k), np.int32)
        for k in ("steps", "support", "n_steps", "n_itemsets",
                  "n_vertices", "pattern_valid", "req")
    }
    return PatternBank(
        patterns=[pattern(p) for p in ref_bank.patterns],
        nv=int(ref_bank.nv), n_label_keys=int(ref_bank.n_label_keys),
        **arrays,
    )
