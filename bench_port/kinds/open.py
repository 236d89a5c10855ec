"""Traffic kind ``open``: one open-loop client in front of the serving
cluster's router.  Arrivals come as a Poisson process at ``rate`` a
second, drawn from the seed, whatever the answers do, and walk the pool in
its generated order, round and round.  The unit is an arrival; its latency
runs from its *scheduled* arrival to the return of the ``collect`` that
answers it, so an arrival that fell due while the client was busy counts
that wait.

The program's server is ``ServingCluster`` over the whole mined bank with
the configuration's ``router`` block (``hosts``, ``flush_batch``,
``max_wait``, ``shed_depth``) and ``server`` block, on ``system.device``.
The client loop: the arrivals due are submitted at once, those that fell
due together as one drain (``submit``; at most the server's ``max_batch``
to a drain); between arrivals it calls ``poll``, waiting on the clock
without sleeping; it collects tickets in submit order, each only once none
of its joins is queued (``DrainTicket.queued``), so the router's own
``flush_batch`` / ``max_wait`` triggers form every batch and ``collect``
only fences.  One op is the loop run until it has collected a ticket.
Set-up mines the bank, sends one drain of ``flush_batch`` DB sequences,
which no arrival repeats, through the cluster and its own triggers (it
builds and loads the kernels outside the schedule), and runs
``warmup_s`` seconds of arrivals through it; the schedule then pauses
until the window's first op, so the window opens in steady state.

Mix parameters: ``rate``, ``pool``, ``warmup_s``, ``check_sample`` and
``profile_ops``.  End-to-end: ``queries_per_s`` (arrivals answered over
the window) and ``query_p95_ms`` (the 95th percentile of their
latencies).

The check (every limit 0; the reference is ``bench_port/reference``'s):
``bank_wrong``; ``answers_missing`` (arrivals submitted and left without
an answer after the window, the traced slice and a closing drain);
``inexact_answers`` (answers flagged ``exact=False``); ``rows_wrong`` and
``topk_wrong`` on ``check_sample`` arrivals drawn from the seed among the
window's first 4 x ``check_sample``, the longest always in
(``check.check_serving``; those a short window did not reach are sent
after it); ``flush_force`` (flushes a ``collect`` forced
before the closing drain: the client never waits on a queued join).

The control (``system.name == "control"``) runs the same schedule over
``system.server``: each drain in one synchronous ``query``.
"""
from __future__ import annotations

import collections
import math
import random
import time
from typing import Dict, List

from bench_port.lib import check, timeline
from bench_port.lib.data import make_inputs, min_support

# the router's histograms whose sum and count the readers take
_HISTOGRAMS = ("queue_wait_seconds", "flush_seconds")


def _spin(dt: float) -> None:
    """Wait ``dt`` seconds on the clock without sleeping: an arrival is
    submitted when it falls due, not when the scheduler wakes the
    client."""
    end = time.perf_counter() + dt
    while time.perf_counter() < end:
        pass


class _Routed:
    """The port's ``ServingCluster``, driven through submit / poll /
    collect."""

    def __init__(self, system, patterns: dict, params: dict, router: dict,
                 clock):
        from repro_torch.serving import compile_bank
        from repro_torch.serving import router as router_mod
        from repro_torch.serving.cluster import ServingCluster

        self.bank = compile_bank(patterns)
        self.cluster = ServingCluster(
            self.bank, router["hosts"], device=system.device,
            max_wait=router["max_wait"], flush_batch=router["flush_batch"],
            shed_depth=router["shed_depth"], clock=clock, **params)
        self.router = self.cluster.router
        # a program whose DrainTicket has no ``queued``: the ticket's
        # joins still in the router's admission queue
        self._private = not isinstance(
            getattr(router_mod.DrainTicket, "queued", None), property)

    def submit(self, seqs):
        return self.cluster.submit({0: seqs})

    def poll(self) -> None:
        self.cluster.poll()

    def ready(self, ticket) -> bool:
        if self._private:
            queue = {id(e) for e in self.router._queue}
            return not any(id(v) in queue for v in ticket.rows.values())
        return ticket.queued == 0

    def collect(self, ticket) -> list:
        return self.cluster.collect(ticket)[0]

    def rows(self):
        return list(zip(self.bank.patterns,
                        (int(s) for s in self.bank.support)))

    @staticmethod
    def answer(a):
        return a.contained, a.topk

    @staticmethod
    def exact(a) -> bool:
        return bool(a.exact)

    def flush_force(self) -> int:
        return int(self.router.stats["flush_force"])

    def counters(self) -> Dict[str, float]:
        """The router's counters by their own names, and the sum and
        count of its histograms (``cluster.router.<histogram>.sum``)."""
        out = {k: v for k, v in self.router.stats.items()}
        snap = self.cluster.metrics.snapshot("cluster.router.")
        for h in _HISTOGRAMS:
            for f in ("sum", "count"):
                key = f"cluster.router.{h}.{f}"
                out[key] = snap.get(key, 0)
        return out


class _Plain:
    """The control's client: ``system.server`` answers each drain at
    once."""

    def __init__(self, system, patterns: dict, params: dict):
        self.server = system.server(patterns, params)

    def submit(self, seqs):
        return self.server.query(seqs)

    def poll(self) -> None:
        pass

    @staticmethod
    def ready(ticket) -> bool:
        return True

    @staticmethod
    def collect(ticket) -> list:
        return ticket

    def rows(self):
        return self.server.rows()

    def answer(self, a):
        return self.server.answer(a)

    @staticmethod
    def exact(a) -> bool:
        return True

    @staticmethod
    def flush_force() -> int:
        return 0

    def counters(self) -> Dict[str, float]:
        return self.server.counters()


class Work:
    """The window keeps the latencies of its answers and the answers of
    the sampled arrivals, and nothing else that grows with it."""

    # the longest an op runs without collecting a ticket, and the longest
    # the client waits between two looks at the schedule and the router
    OP_MAX_S = 1.0
    POLL_S = 1e-3

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
        self.router_cfg = dict(cfg["router"])
        self.rate = float(mix["rate"])
        # the schedule's clock and wait; the tests put a fake clock here
        # before set-up (the router reads the same clock)
        self.clock = time.perf_counter
        self.sleep = _spin
        # a stall (a collect, the profiler) turns into drains of at most
        # a batch, not one drain of thousands whose launches all precede
        # its first collect and hold their device memory meanwhile
        self.take = self.params["max_batch"]
        self._gaps = random.Random(seed ^ 0x0A77)
        self.next_k = 0          # ordinal of the next arrival to submit
        self.next_s = 0.0        # its schedule time, s from the origin
        self.origin = 0.0        # the schedule's origin on the clock
        self.paused = None       # clock reading where the schedule paused
        self.k_window = 0        # ordinal of the window's first arrival
        self.in_window = False
        self.tickets = collections.deque()  # (ticket, ordinals, due times)
        self.submitted = 0
        self.answered_all = 0
        self.inexact = 0
        self.latencies: List[float] = []    # the window's answers
        self.kept: Dict[int, list] = {}     # sampled pool index -> answers
        self.sample: set = set()
        self.client = None

    # ---------------------------------------------------------- the loop
    def _submit(self, now: float, end: float = math.inf) -> int:
        """Submit, as one drain of at most ``take``, the arrivals due by
        ``now`` and ordered before ``end``; returns how many."""
        ks, due = [], []
        while (self.origin + self.next_s <= now and self.next_k < end
               and len(ks) < self.take):
            ks.append(self.next_k)
            due.append(self.origin + self.next_s)
            self.next_k += 1
            self.next_s += self._gaps.expovariate(self.rate)
        if ks:
            n = len(self.pool)
            ticket = self.client.submit([self.pool[k % n] for k in ks])
            self.tickets.append((ticket, ks, due))
            self.submitted += len(ks)
        return len(ks)

    def _step(self) -> tuple:
        """Submit every arrival due, poll, collect every ready ticket;
        returns (arrivals submitted, tickets collected)."""
        n = self._submit(self.clock())
        self.client.poll()
        got = 0
        while self.tickets and self.client.ready(self.tickets[0][0]):
            self._collect(*self.tickets.popleft())
            got += 1
        return n, got

    def _collect(self, ticket, ks: List[int], due: List[float]) -> None:
        answers = self.client.collect(ticket)
        done = self.clock()
        n = len(self.pool)
        for k, t, a in zip(ks, due, answers):
            self.answered_all += 1
            self.inexact += not self.client.exact(a)
            if self.in_window:
                self.latencies.append(done - t)
            if k - self.k_window in self.sample:
                self.kept.setdefault(k % n, []).append(a)

    def _wait(self) -> None:
        """Wait until the next arrival falls due, at most ``POLL_S``."""
        dt = min(self.origin + self.next_s - self.clock(), self.POLL_S)
        if dt > 0:
            self.sleep(dt)

    def _sample(self) -> set:
        """Ordinals, counted from the window's first arrival, of the
        arrivals to check: drawn from the seed among the window's first
        4 x ``check_sample``, with the longest always in."""
        m = 4 * self.mix["check_sample"]
        n = len(self.pool)
        pick = set(random.Random(self.seed ^ 0x09E7).sample(
            range(m), min(self.mix["check_sample"], m)))
        pick.add(max(range(m), key=lambda j: (
            sum(map(len, self.pool_ref[(self.k_window + j) % n])), -j)))
        return pick

    # --------------------------------------------------------- interface
    def setup(self) -> None:
        patterns = self.system.mine(self.db, self.sigma,
                                    self.max_len).patterns
        if self.system.name == "control":
            self.client = _Plain(self.system, patterns, self.params)
        else:
            self.client = _Routed(self.system, patterns, self.params,
                                  self.router_cfg, self.clock)
            warm = self.client.submit(
                self.db[:self.router_cfg["flush_batch"]])
            while not self.client.ready(warm):
                self.client.poll()
                self.sleep(self.POLL_S)
            self.client.collect(warm)
        self.origin = self.clock()
        self.next_s = self._gaps.expovariate(self.rate)
        while self.clock() - self.origin < self.mix["warmup_s"]:
            self._step()
            self._wait()
        self.paused = self.clock()
        self.k_window = self.next_k
        self.sample = self._sample()

    def op(self) -> int:
        if self.paused is not None:
            self.origin += self.clock() - self.paused
            self.paused = None
            self.in_window = True
        units = 0
        end = self.clock() + self.OP_MAX_S
        while True:
            n, got = self._step()
            units += n
            if got or self.clock() >= end:
                return units
            self._wait()

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        out = {"queries_per_s": len(self.latencies) / window_s}
        if self.latencies:
            out["query_p95_ms"] = 1e3 * timeline.p95(self.latencies)
        return out

    def counters(self) -> Dict[str, float]:
        return dict(self.system.launches(), **self.client.counters())

    def checks(self, seed: int) -> List[Dict]:
        forced = self.client.flush_force()
        self.in_window = False
        # sampled arrivals that a short window never reached are sent
        # now, so that every sampled arrival is answered and checked
        end = self.k_window + 4 * self.mix["check_sample"]
        while self._submit(math.inf, end):
            pass
        while self.tickets:
            self._collect(*self.tickets.popleft())
        want = check.reference_map(self.db_ref, self.sigma, self.max_len)
        out = check.check_serving(self.client, self.kept,
                                  self.submitted - self.answered_all,
                                  self.pool_ref, want, self.params["topk"])
        out.insert(2, check.check("inexact_answers", self.inexact, 0))
        out.append(check.check("flush_force", forced, 0))
        return out
