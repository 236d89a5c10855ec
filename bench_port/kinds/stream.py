"""Traffic kind ``stream``: one closed-loop writer observing batches of
``batch`` pool sequences into a sliding window, each batch after the last
one's ``observe`` (and the refresh it carries) has returned.  The unit is
an arrival, answered by its containment row; an arrival's latency is its
batch's.

The program's window is ``StreamingBank.from_db`` on the configuration's
DB, with its ``stream`` block (``window``, ``refresh_every``,
``compact_threshold``, ``tombstones``) and its ``server`` block, on
``system.device``; set-up then feeds it ``warmup_batches`` batches, so
the window opens in steady state.  The batches walk the pool in its
generated order, round and round, and a refresh runs inside the
``observe`` it is due in.  Mix parameters: ``batch``, ``pool``,
``warmup_batches``, ``check_sample``, ``check_refreshes`` and
``profile_ops``.  End-to-end: ``queries_per_s`` (arrivals answered over
the window) and ``query_p95_ms`` (the 95th percentile of every batch's
wall, the refresh it carries included).

The check (every limit 0; the reference is ``bench_port/reference``'s):

* ``bank_wrong``: the seeded window's map (``frequent()`` right after
  ``from_db``) against the reference's mine of the DB;
* ``answers_missing``: arrivals of the window that came back without a
  row;
* ``window_wrong``: the map after each of the window's first
  ``check_refreshes`` refreshes, and after a closing ``refresh()``, each
  against the reference's mine of that window's sequences (patterns
  missing, extra or at another support, summed);
* ``rows_wrong``: ``check_sample`` arrivals drawn from the seed among the
  window's first 4 batches, the longest always in: each row against
  Def. 4 containment on every bank row that was active when it joined,
  and False on the rest (arrivals with any bit wrong).

The control (``system.name == "control"``) runs a plain stream of the
same shape built from ``system.mine`` and ``system.server``: it re-mines
the window at each refresh and answers each arrival by the server's
containment over the mined map.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Dict, List

import numpy as np

from bench_port.lib import check, timeline
from bench_port.lib.data import make_inputs, min_support
from bench_port.reference.containment import contains

# histogram fields that do not add up over a window
_NOT_ADDITIVE = ("min", "max", "mean", "p50", "p95", "p99")


class _ProgramStream:
    """The port's ``StreamingBank``, seeded by the DB."""

    def __init__(self, system, db, sigma: int, max_len: int, stream: dict,
                 params: dict):
        from repro_torch.serving import streaming

        self.sb = streaming.StreamingBank.from_db(
            db, minsup=sigma, window=stream["window"], max_len=max_len,
            refresh_every=stream["refresh_every"],
            compact_threshold=stream["compact_threshold"],
            tombstones=stream["tombstones"], device=system.device, **params)
        # a program whose ObserveResult carries no rows: they are taken
        # from the one join its observe makes
        self._tap = "rows" not in {
            f.name for f in dataclasses.fields(streaming.ObserveResult)}

    @property
    def active(self) -> np.ndarray:
        return self.sb.active

    @property
    def patterns(self) -> list:
        return self.sb.bank.patterns

    def observe(self, seqs):
        if not self._tap:
            res = self.sb.observe(seqs)
            return res.rows, res.refreshed
        srv = self.sb.server
        join = srv.exact_rows
        got = []

        def tapped(batch):
            got.append(join(batch))
            return got[-1]

        srv.exact_rows = tapped
        try:
            res = self.sb.observe(seqs)
        finally:
            del srv.exact_rows
        return (got[0] if got else None), res.refreshed

    def refresh(self) -> dict:
        return self.sb.refresh()

    def frequent(self) -> dict:
        return self.sb.frequent()

    def counters(self) -> Dict[str, float]:
        """``StreamingBank.stats`` by their own names, and the miners'
        ``mining.*`` counters in the bank's registry."""
        out = {k: v for k, v in self.sb.metrics.snapshot("mining.").items()
               if k.rsplit(".", 1)[-1] not in _NOT_ADDITIVE}
        out.update(self.sb.stats)
        return out


class _PlainStream:
    """The control's stream: the window re-mined with ``system.mine`` at
    each refresh, arrivals answered by ``system.server`` over that map."""

    def __init__(self, system, db, sigma: int, max_len: int, stream: dict,
                 params: dict):
        self.system = system
        self.sigma = sigma
        self.max_len = max_len
        self.params = params
        self.every = stream["refresh_every"]
        self.win = collections.deque(db, maxlen=stream["window"])
        self.refresh()

    def refresh(self) -> dict:
        self.since = 0
        self.map = self.system.mine(list(self.win), self.sigma,
                                    self.max_len).patterns
        self.server = self.system.server(self.map, self.params)
        self.patterns = [p for p, _ in self.server.rows()]
        self.active = np.ones(len(self.patterns), bool)
        return dict(self.map)

    def observe(self, seqs):
        rows = np.zeros((len(seqs), len(self.patterns)), bool)
        for j, a in enumerate(self.server.query(seqs)):
            rows[j] = self.server.answer(a)[0]
        self.win.extend(seqs)
        self.since += 1
        refreshed = self.since >= self.every
        if refreshed:
            self.refresh()
        return rows, refreshed

    def frequent(self) -> dict:
        return dict(self.map)

    @staticmethod
    def counters() -> Dict[str, float]:
        return {}


class Work:
    """The window keeps, besides the latencies, the pool indices of the
    window at each checked refresh with the map it gave, and the rows of
    the sampled arrivals with the bank's active mask and patterns from
    before their batch; nothing else grows as the window goes on."""

    CHECKED_BATCHES = 4

    def __init__(self, system, cfg: dict, mix: dict, seed: int):
        self.system = system
        self.mix = mix
        self.seed = seed
        self.db_ref, self.pool_ref = make_inputs(cfg, seed, mix["pool"])
        self.db = system.native(self.db_ref)
        self.pool = system.native(self.pool_ref)
        self.stream_cfg = dict(cfg["stream"])
        self.sigma = min_support(cfg, self.stream_cfg["window"])
        self.max_len = cfg["max_len"]
        self.params = dict(cfg["server"])
        # the window's sequences as indices: pool index i, DB index d as
        # -1 - d
        self.win = collections.deque(
            (-1 - d for d in range(len(self.db))),
            maxlen=self.stream_cfg["window"])
        self.pos = 0
        self.latencies: List[float] = []
        self.answered = 0
        self.missing = 0
        self.arrived = 0
        self.windows: List[tuple] = []   # (window indices, map)
        self.kept: List[tuple] = []      # (pool index, row, active, patterns)
        self.stream = None

    def _next(self) -> List[int]:
        n = len(self.pool)
        idx = [(self.pos + j) % n for j in range(self.mix["batch"])]
        self.pos = (self.pos + self.mix["batch"]) % n
        return idx

    def _sample(self) -> set:
        """Ordinals of the window's arrivals to check: drawn from the
        seed among its first batches, with the longest always in."""
        n = len(self.pool)
        first = [(self.pos + j) % n
                 for j in range(self.CHECKED_BATCHES * self.mix["batch"])]
        pick = set(random.Random(self.seed ^ 0x5EA3).sample(
            range(len(first)), min(self.mix["check_sample"], len(first))))
        pick.add(max(range(len(first)), key=lambda j: (
            sum(map(len, self.pool_ref[first[j]])), -j)))
        return pick

    def setup(self) -> None:
        make = _PlainStream if self.system.name == "control" else \
            _ProgramStream
        self.stream = make(self.system, self.db, self.sigma, self.max_len,
                           self.stream_cfg, self.params)
        self.seeded = self.stream.frequent()
        for _ in range(self.mix["warmup_batches"]):
            idx = self._next()
            self.stream.observe([self.pool[i] for i in idx])
            self.win.extend(idx)
        self.sample = self._sample()

    def op(self) -> int:
        idx = self._next()
        seqs = [self.pool[i] for i in idx]
        picked = [j for j in range(len(idx))
                  if self.arrived + j in self.sample]
        if picked:
            before = (self.stream.active.copy(), list(self.stream.patterns))
        t0 = time.perf_counter()
        rows, refreshed = self.stream.observe(seqs)
        self.latencies.append(time.perf_counter() - t0)
        got = 0 if rows is None else min(len(rows), len(idx))
        self.answered += got
        self.missing += len(idx) - got
        self.win.extend(idx)
        for j in picked:
            if j < got:
                self.kept.append((idx[j], np.array(rows[j], bool), *before))
        self.arrived += len(idx)
        if refreshed and len(self.windows) < self.mix["check_refreshes"]:
            self.windows.append((list(self.win), self.stream.frequent()))
        return len(idx)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"queries_per_s": self.answered / window_s,
                "query_p95_ms": 1e3 * timeline.p95(self.latencies)}

    def counters(self) -> Dict[str, float]:
        return dict(self.system.launches(), **self.stream.counters(),
                    batches=len(self.latencies))

    def _seq(self, i: int):
        return self.pool_ref[i] if i >= 0 else self.db_ref[-1 - i]

    def checks(self, seed: int) -> List[Dict]:
        final = self.stream.refresh()
        want = check.reference_map(self.db_ref, self.sigma, self.max_len)
        out = [check.check("bank_wrong", check.map_diff(self.seeded, want),
                           0),
               check.check("answers_missing", self.missing, 0)]
        window_wrong = 0
        for idx, got in self.windows + [(list(self.win), final)]:
            want = check.reference_map([self._seq(i) for i in idx],
                                       self.sigma, self.max_len)
            window_wrong += check.map_diff(got, want)
        out.append(check.check("window_wrong", window_wrong, 0))
        ref: Dict = {}
        rows_wrong = 0
        for i, row, active, patterns in self.kept:
            want = np.zeros(len(patterns), bool)
            for r in np.nonzero(active)[0]:
                p = patterns[r]
                if p not in ref:
                    ref[p] = check.to_reference(p)
                want[r] = contains(ref[p], self.pool_ref[i])
            rows_wrong += not np.array_equal(row, want)
        out.append(check.check("rows_wrong", rows_wrong, 0))
        return out
