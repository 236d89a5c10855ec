"""Inputs of a run: the DB and the query pool, made from a config and a seed.

Every seed gets the same work in another form.  The DB and the pool come
from the config's generator at the config's own fixed seeds, so their
sizes, the patterns they hold and the cost of every query are the same
in every run; ``--seed`` then permutes each sequence's vertex IDs and
the order of the DB's sequences.  Patterns are canonical under vertex
renaming and supports do not depend on the order, so every seed mines
the same map and answers the same rows, from inputs that differ in every
ID the program encodes: runs with different seeds differ in their
inputs, not in how much there is to do, and their spread is the
program's and the host's.

A config's generator is ``generators/<name>.py``, which calls the
reference's copy (``reference.synthetic``); the harness hands the same
sequences to the program (converted to its own classes by ``systems``)
and to the reference.
"""
from __future__ import annotations

import random
from typing import List

from . import registry
from ..reference.graphseq import TR, TRSeq


def generate(spec: dict, seed: int, size: int | None = None) -> List[TRSeq]:
    """Sequences of a config's ``db`` or ``query_pool`` block; ``size``
    overrides the generator's count key (``size_key``)."""
    params = dict(spec["params"])
    if size is not None:
        params[spec["size_key"]] = size
    return registry.generator(spec["generator"]).generate(params, seed)


def renumber(s: TRSeq, rng: random.Random) -> TRSeq:
    """``s`` with its vertex IDs permuted among themselves (edge
    endpoints kept in order, each TR where it was)."""
    ids = sorted({v for itemset in s for tr in itemset for v in tr.vertices()})
    new = list(ids)
    rng.shuffle(new)
    m = dict(zip(ids, new))
    out = []
    for itemset in s:
        trs = []
        for tr in itemset:
            if tr.is_vertex:
                trs.append(TR(tr.type, m[tr.u1], tr.u2, tr.label))
            else:
                a, b = m[tr.u1], m[tr.u2]
                trs.append(TR(tr.type, min(a, b), max(a, b), tr.label))
        out.append(tuple(trs))
    return tuple(out)


def min_support(cfg: dict, n: int) -> int:
    """sigma: the config's ``min_support_frac`` of the DB's size, as the
    repository's launchers take it (``int(frac * |DB|)``, at least 2)."""
    return max(2, int(cfg["min_support_frac"] * n))


def make_inputs(cfg: dict, seed: int, pool_size: int | None = None):
    """``(db, pool)`` for a run: the config's DB (and, when ``pool_size``
    is given, that many pool sequences), every sequence's vertex IDs
    permuted by the seed, the DB in the seed's order.  The pool keeps its
    generated order: the traffic mix decides the order of the queries."""
    rng = random.Random(seed)
    db = [renumber(s, rng)
          for s in generate(cfg["db"], cfg["db"]["seed"])]
    rng.shuffle(db)
    pool = []
    if pool_size:
        pool = [renumber(s, rng) for s in generate(
            cfg["query_pool"], cfg["query_pool"]["seed"], size=pool_size)]
    return db, pool
