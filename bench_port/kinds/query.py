"""Traffic kind ``query``: one closed-loop client sending batches of
``batch`` pool sequences to one server, each batch after the last one's
answer.  The unit is a query; a query's latency is its batch's.

The batches walk the pool in its generated order, round and round.  Mix
parameters: ``pool`` (the sequences of the query pool), ``batch``,
``warmup_batches``, ``check_sample`` and ``profile_ops``.  End-to-end: ``queries_per_s`` (answers over the
window) and ``query_p95_ms`` (the 95th percentile of every batch's
latency).
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

from bench_port.lib import check, timeline
from bench_port.lib.data import make_inputs, min_support


class _Cyclic:
    """Pool indices batch by batch: the pool in its generated order,
    round and round."""

    def __init__(self, batch: int, n_pool: int):
        self.batch = batch
        self.n = n_pool
        self.pos = 0

    def next(self) -> List[int]:
        idx = [(self.pos + j) % self.n for j in range(self.batch)]
        self.pos = (self.pos + self.batch) % self.n
        return idx


class Work:
    """The check's sample is drawn in set-up, from the seed, among the
    distinct sequences of the first batches (those a window
    always reaches), with the longest of them always in; the window keeps
    the first ``KEEP`` answers given to each sampled sequence and nothing
    else, so the harness holds no more objects as the window goes on."""

    KEEP = 4

    def __init__(self, system, cfg: dict, mix: dict, seed: int):
        self.system = system
        self.mix = mix
        self.seed = seed
        self.db_ref, self.pool_ref = make_inputs(cfg, seed, mix["pool"])
        self.db = system.native(self.db_ref)
        self.pool = system.native(self.pool_ref)
        self.sigma = min_support(cfg, len(self.db))
        self.max_len = cfg["max_len"]
        self.params = dict(cfg["server"])
        self.latencies: List[float] = []
        self.answered = 0
        self.missing = 0
        self.kept: Dict[int, list] = {}     # sampled pool index -> answers
        self.server = None

    def _sample(self) -> set:
        n = self.mix["check_sample"]
        order = _Cyclic(self.mix["batch"], len(self.pool))
        first = sorted({i for _ in range(-(-4 * n // self.mix["batch"]))
                        for i in order.next()})
        pick = set(random.Random(self.seed ^ 0xC4EC).sample(
            first, min(n, len(first))))
        pick.add(max(first, key=lambda i: (sum(map(len, self.pool_ref[i])),
                                           -i)))
        return pick

    def setup(self) -> None:
        """Mine the bank on the device, compile it, and warm a throwaway
        server on the mix's first ``warmup_batches`` batches; the window
        gets a fresh server (cold cache) and the order from its start."""
        patterns = self.system.mine(self.db, self.sigma,
                                    self.max_len).patterns
        warm = self.system.server(patterns, self.params)
        order = _Cyclic(self.mix["batch"], len(self.pool))
        for _ in range(self.mix["warmup_batches"]):
            warm.query([self.pool[i] for i in order.next()])
        self.server = self.system.server(patterns, self.params)
        self.order = _Cyclic(self.mix["batch"], len(self.pool))
        self.sample = self._sample()

    def op(self) -> int:
        idx = self.order.next()
        seqs = [self.pool[i] for i in idx]
        t0 = time.perf_counter()
        ans = self.server.query(seqs)
        self.latencies.append(time.perf_counter() - t0)
        self.answered += len(ans)
        self.missing += max(0, len(idx) - len(ans))
        for i, a in zip(idx, ans):
            if i in self.sample:
                kept = self.kept.setdefault(i, [])
                if len(kept) < self.KEEP:
                    kept.append(a)
        return len(idx)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"queries_per_s": self.answered / window_s,
                "query_p95_ms": 1e3 * timeline.p95(self.latencies)}

    def counters(self) -> Dict[str, float]:
        return dict(self.system.launches(), **self.server.counters(),
                    batches=len(self.latencies))

    def checks(self, seed: int) -> List[Dict]:
        want = check.reference_map(self.db_ref, self.sigma, self.max_len)
        return check.check_serving(self.server, self.kept, self.missing,
                                   self.pool_ref, want,
                                   self.params["topk"])
