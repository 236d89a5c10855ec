"""Fault injection and fault semantics for the serving cluster.

``ClusterHost.call`` is the host boundary every cross-host access goes
through (serving.cluster), and until now every call was assumed to
succeed instantly - a single slow or dead host would wedge
``ClusterRouter.collect`` forever and silently lose queries.  This
module defines the failure model the router (and, later, real
process-group hosts) programs against:

* ``FaultInjector`` - a *deterministic* fault schedule installed at the
  ``ClusterHost.call`` boundary.  Every decision is a stateless hash of
  ``(seed, host, per-host call index)`` - no RNG object, no query-time
  entropy - so a faulted run replays **bit-identically**: the same
  queries see the same delays, the same transient errors, the same
  crash windows.  Crash/blackout windows are wall-clock intervals on
  the *injectable* clock, so tests drive them with a fake clock.  An
  idle injector (all rates 0, no blackouts) only counts calls: results
  are bit-identical to no injector at all.
* The **fault taxonomy** the router handles (all carry the host id):
  ``TransientHostError`` (retryable one-off), ``HostTimeoutError``
  (call exceeded the policy's per-call timeout; the result is
  discarded), ``HostDownError`` (the host is inside a crash/blackout
  window).  ``HostFault`` is their common base.
* ``HostUnavailableError`` - what the *router* raises after the ladder
  is exhausted: retries spent, or the host's circuit breaker is open.
  Callers with an exactness contract (``ClusterRouter.joined_rows``,
  hence the streaming window protocol) see this instead of silently
  degraded bits.
* ``RetryPolicy`` - per-call timeout, capped exponential backoff retry
  budget, and the circuit-breaker knobs (consecutive-failure threshold,
  open-state cooldown before a half-open probe).
* ``RecoveryLog`` - a bounded ring of the writer's sequenced deltas
  (serving.streaming ships ``(kind, seq, *payload)`` tuples) that a
  restarted replica replays from its last applied sequence number;
  ``since()`` returns None when the ring already evicted the needed
  range, forcing a full state transfer instead of a wrong partial one.
* ``PipelineBusyError`` - the typed quiescence refusal for
  ``apply_row_mask``/``set_row_mask``: names the queued / in-flight /
  uncollected-ticket counts instead of a bare ``assert`` (asserts
  vanish under ``python -O``; a survived re-mask would hand out stale
  cached rows).

Counter inventory (registered under ``cluster.faults`` by the router,
incremented here and in router.py): ``injected`` (faults the injector
raised or delayed), ``retries`` (backoff retries issued), ``breaker_open``
(circuit-breaker open transitions), ``failovers`` (batches answered by
a promoted read replica, exact), ``degraded_answers`` (queries answered
from the host-side prescreen, ``exact=False``), ``recoveries`` (hosts
that passed a half-open probe / replicas that completed a verified
catch-up), plus the ``cluster.faults.retry_seconds`` latency histogram.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ------------------------------------------------------------ exceptions
class HostFault(Exception):
    """Base of every injected/observed fault at the host boundary."""

    def __init__(self, hid: int, msg: str = ""):
        self.hid = hid
        super().__init__(msg or f"host {hid} fault")


class TransientHostError(HostFault):
    """A one-off failure (dropped RPC, OOM-killed worker retry-able at
    the caller): succeeds on retry unless the schedule says otherwise."""


class HostTimeoutError(HostFault):
    """The call exceeded ``RetryPolicy.call_timeout`` on the injectable
    clock; the (possibly computed) result is discarded - a timed-out
    answer must not be half-used."""


class HostDownError(HostFault):
    """The host is inside a crash/blackout window (or a crashed replica
    was queried): every call fails until the window ends and the host
    restarts."""


class HostUnavailableError(Exception):
    """The router exhausted the retry budget or the host's circuit
    breaker is open: the caller must fail over (replica / prescreen) or
    propagate.  Deliberately NOT a ``HostFault``: it is a router-side
    verdict, not a boundary event."""

    def __init__(self, hid: int, msg: str = ""):
        self.hid = hid
        super().__init__(msg or f"host {hid} unavailable")


class PipelineBusyError(RuntimeError):
    """Typed quiescence refusal: the admission pipeline still holds
    work launched against pre-mask state, so re-masking must wait.
    Carries the counts a caller needs to drain."""

    def __init__(self, queued: int, inflight: int, tickets: int):
        self.queued = queued
        self.inflight = inflight
        self.tickets = tickets
        super().__init__(
            f"admission pipeline not quiescent: {queued} queued "
            f"miss(es), {inflight} in-flight miss(es), {tickets} "
            "uncollected ticket(s) - collect every ticket before "
            "changing the row mask"
        )


# ---------------------------------------------------------- retry policy
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the router treats host faults (see module docstring).

    ``call_timeout`` is measured on the router's injectable clock
    around each attempt (None = never time out).  A failed attempt
    retries up to ``retries`` times with capped exponential backoff
    (``backoff_base * 2^attempt``, clamped at ``backoff_cap``).
    ``breaker_threshold`` consecutive failures open the host's circuit
    breaker; after ``breaker_cooldown`` seconds one half-open probe is
    allowed - success closes the breaker (and counts a recovery),
    failure re-opens it."""

    call_timeout: Optional[float] = None
    retries: int = 2
    backoff_base: float = 0.05
    backoff_cap: float = 1.0
    breaker_threshold: int = 3
    breaker_cooldown: float = 5.0


# --------------------------------------------------------- fault injector
def _unit_hash(seed: int, hid: int, idx: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, host, call index) -
    a stateless hash, so schedules replay bit-identically and two
    injectors with the same seed agree without shared state."""
    h = hashlib.blake2b(
        f"{seed}:{hid}:{idx}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class FaultInjector:
    """Seeded fault schedule at the ``ClusterHost.call`` boundary.

    Install via ``ServingCluster(injector=...)`` (which sets it on
    every host and binds its counter to the cluster registry) or by
    assigning ``host.injector``.  Per call it draws one deterministic
    unit hash: ``u < error_rate`` raises ``TransientHostError``,
    ``u < error_rate + delay_rate`` sleeps ``delay`` seconds through
    the injectable ``sleep`` (tests pass a fake-clock advance; with a
    real clock it defaults to ``time.sleep``), otherwise the call
    proceeds.  Blackout windows ``(hid, t0, t1)`` are checked first
    against the injectable ``clock``: inside one, every call to that
    host raises ``HostDownError`` - the crash simulation.

    No RNG at query time: ``decide(hid, idx)`` is a pure function, so
    replaying the same traffic yields the same faults."""

    def __init__(
        self,
        seed: int = 0,
        *,
        error_rate: float = 0.0,
        delay_rate: float = 0.0,
        delay: float = 0.01,
        blackouts: Sequence[Tuple[int, float, float]] = (),
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        assert 0.0 <= error_rate <= 1.0 and 0.0 <= delay_rate <= 1.0
        assert error_rate + delay_rate <= 1.0
        self.seed = seed
        self.error_rate = error_rate
        self.delay_rate = delay_rate
        self.delay = delay
        self.blackouts = tuple(
            (int(h), float(t0), float(t1)) for h, t0, t1 in blackouts
        )
        self.clock = time.monotonic if clock is None else clock
        # with an injected (fake) clock the default sleep is a no-op:
        # the test advances time itself; a real-clock injector really
        # sleeps so delay faults show up in the latency histograms
        self.sleep = sleep if sleep is not None else (
            time.sleep if clock is None else (lambda s: None)
        )
        self.calls: Dict[int, int] = {}   # per-host call counter
        self._c_injected = None           # bound by bind()

    def bind(self, metrics) -> None:
        """Attach the ``cluster.faults.injected`` counter to a
        registry (ServingCluster does this at construction)."""
        self._c_injected = metrics.counter("cluster.faults.injected")

    def _count(self) -> None:
        if self._c_injected is not None:
            self._c_injected.inc()

    def decide(self, hid: int, idx: int) -> str:
        """The pure schedule: ``"error"`` | ``"delay"`` | ``"ok"`` for
        the ``idx``-th call to host ``hid`` (blackouts are clock-based
        and checked separately in ``on_call``)."""
        u = _unit_hash(self.seed, hid, idx)
        if u < self.error_rate:
            return "error"
        if u < self.error_rate + self.delay_rate:
            return "delay"
        return "ok"

    def down(self, hid: int) -> bool:
        """True while ``hid`` is inside a blackout window now."""
        t = self.clock()
        return any(h == hid and t0 <= t < t1
                   for h, t0, t1 in self.blackouts)

    def on_call(self, hid: int) -> None:
        """The ``ClusterHost.call`` hook: raise/delay per the schedule
        (called before the wrapped function runs, so a failed call
        never half-executes)."""
        idx = self.calls.get(hid, 0)
        self.calls[hid] = idx + 1
        if self.down(hid):
            self._count()
            raise HostDownError(
                hid, f"host {hid} is inside a blackout window")
        verdict = self.decide(hid, idx)
        if verdict == "error":
            self._count()
            raise TransientHostError(
                hid, f"injected transient error (call #{idx})")
        if verdict == "delay":
            self._count()
            self.sleep(self.delay)

    def reset(self) -> None:
        """Forget the per-host call counters (restart the schedule)."""
        self.calls.clear()


# ----------------------------------------------------------- recovery log
class RecoveryLog:
    """Bounded ring of the writer's sequenced deltas, for replica
    restart replay.  ``append`` evicts oldest-first past ``capacity``;
    ``since(last_seq)`` returns every retained delta with a sequence
    number beyond ``last_seq``, or ``None`` when the ring has already
    evicted part of that range (the caller must full-resync - replaying
    a gapped suffix would silently corrupt the replica)."""

    def __init__(self, capacity: int = 256):
        assert capacity >= 1
        self.capacity = capacity
        self.entries: "deque[Tuple[int, Tuple]]" = deque()
        self.dropped_through = 0   # highest evicted sequence number

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def last_seq(self) -> int:
        return self.entries[-1][0] if self.entries else \
            self.dropped_through

    def append(self, seq: int, delta: Tuple) -> None:
        assert seq > self.last_seq, "delta sequence must be monotone"
        self.entries.append((seq, delta))
        while len(self.entries) > self.capacity:
            s, _ = self.entries.popleft()
            self.dropped_through = s

    def since(self, last_seq: int) -> Optional[List[Tuple]]:
        """Deltas with seq > ``last_seq``, oldest first; None when the
        range was (partially) evicted."""
        if last_seq < self.dropped_through:
            return None
        return [d for s, d in self.entries if s > last_seq]
