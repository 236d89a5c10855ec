"""Cross-host request batching and result merging for the serving
cluster.

The reverse-search decomposition that makes mining parallel also makes
the mined bank *shardable with zero cross-shard joins*: containment of
sequence ``b`` in pattern ``p`` touches only ``b`` and ``p``, so a bank
split across hosts answers any query as the disjoint union of per-shard
answers.  This module is the query plane over such a split:

* ``plan_placement`` - which host owns which bank rows.  Trie banks
  place by depth-1 subtree (``TrieBank.shard_rows``: a subtree is never
  torn across hosts, so every host joins intact sub-tries and keeps the
  shared-prefix savings); flat banks place by contiguous pattern range.
* ``ClusterRouter.route`` - takes the queries that arrived on *all*
  hosts in one drain, dedups them by canonical fingerprint, resolves
  the two-level cache (host-local L1, then the fingerprint owner's L2),
  and joins every remaining miss in one batch per shard - requests that
  arrived on different hosts share device batches.  Per-shard rows
  scatter back into global bank order and the global top-k is scored
  over the merged row, so routed answers are bit-equal to a single-host
  ``PatternServer`` over the unsharded bank.
* ``ClusterRouter.submit/poll/collect`` - the async admission pipeline
  over the same cache/join/merge machinery (continuous batching):

      submit -> [admission queue] -> flush -> [in-flight batches]
                                                  -> collect

  ``submit`` resolves caches immediately and enqueues the misses
  (deduped against queued *and* in-flight fingerprints - a repeat
  arriving while its first copy is still on device piggybacks instead
  of re-joining).  A **flush** launches one batch per shard
  (``PatternServer.launch_rows`` with one shared query encoding,
  ``server.encode_queries``) and does NOT block: a CUDA launch is
  async, so the joins compute while later submits keep accumulating.
  Flush triggers: queue reached ``flush_batch`` (reason ``batch``),
  head-of-queue older than ``max_wait`` (reason ``deadline``, checked
  at every submit/poll against the injectable ``clock``), or a
  ``collect`` needing unresolved rows (reason ``force``); a client
  that leaves batching to the first two collects a ticket once its
  ``DrainTicket.queued`` reads 0.  ``collect``
  fences in admission order (``finalize_rows`` per shard), fills L2
  then L1 exactly like the synchronous path, and returns per-host
  results - bit-equal to ``route`` and the single-host server.

  **Load shedding**: with ``shed_depth`` set, a miss admitted while
  ``queue + in-flight >= shed_depth`` is not joined at all - it is
  answered from the host-side counts prescreen
  (``PatternServer.approx_rows``), a sound overapproximation flagged
  ``exact=False`` and never cached.  Off by default: exactness stays
  the default contract.

  There is one cluster-wide admission queue, not one per shard: every
  miss fans out to *all* shards (each answers its own column block),
  so per-shard queues would always flush in lockstep anyway - the
  per-shard split happens at flush time, one ``launch_rows`` per
  shard over the same batch.

Two-level cache: L1 is per-host (an arrival host answers replays of its
own traffic without any cross-host hop); L2 entries live on the
fingerprint's *owner* host (``hash(fp) % n_hosts``), so a sequence
first served on host A is a single-hop cache hit when it later arrives
on host B.  Both are keyed by the renaming-invariant
``sequence_fingerprint``, so vertex-renamed replays hit either level.

Hosts are duck-typed (see ``serving.cluster.ClusterHost``): the router
needs ``rows`` (owned global bank rows), ``server`` (a shard
``PatternServer``), ``l1``/``l2`` ordered dicts with ``l1_size``/
``l2_size`` bounds, and ``call(fn, *args)`` - the host-boundary hook
(in-process simulated hosts just call; a ``torch.distributed``-style
process group would RPC and copy to its device behind the same
interface).  The shared query encoding is built once per device the
live shards serve on (``_encodings``): one for the usual single card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..core.graphseq import TRSeq
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from .bank import PatternBank, sequence_fingerprint
from .faults import (
    HostFault,
    HostTimeoutError,
    HostUnavailableError,
    PipelineBusyError,
    RetryPolicy,
)
from .layouts import get_layout
from .server import (QueryResult, SharedEncoding, encode_queries,
                     prescreen_rows, score_topk)
from .trie import REQ_MASKED, TrieBank


@dataclasses.dataclass
class BankPlacement:
    """Which global bank rows each shard owns.  ``rows[s]`` is sorted,
    and the row sets partition ``range(n_patterns)`` (shards may be
    empty - fewer depth-1 subtrees than hosts)."""

    rows: List[np.ndarray]
    layout: str
    n_patterns: int

    @property
    def n_shards(self) -> int:
        return len(self.rows)


def plan_placement(
    bank: PatternBank,
    n_hosts: int,
    *,
    layout: str = "flat",
    trie: Optional[TrieBank] = None,
) -> BankPlacement:
    """Place bank rows onto ``n_hosts`` shards via the layout's
    ``place`` hook (layouts.py): by depth-1 trie subtree for the trie
    layouts (subtrees stay intact per host), by contiguous pattern
    range for flat.  Raises ``ValueError`` on an unregistered layout."""
    assert n_hosts >= 1
    rows = get_layout(layout).place(bank, n_hosts, trie)
    covered = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    assert sorted(covered.tolist()) == list(range(bank.n_patterns))
    return BankPlacement(rows=rows, layout=layout,
                         n_patterns=bank.n_patterns)


def _encodings(seqs: Sequence[TRSeq], hosts) -> Dict[object,
                                                     SharedEncoding]:
    """The query batch encoded once per device the ``hosts``' shard
    servers run on: the encoding depends on the queries alone (every
    shard keeps the global ``n_label_keys``), so the shards of one
    device share one upload and one index build."""
    out: Dict[object, SharedEncoding] = {}
    for h in hosts:
        dev = h.server.device
        if dev not in out:
            out[dev] = encode_queries(
                seqs, n_label_keys=h.server.bank.n_label_keys, device=dev)
    return out


def _cache_put(cache: "Dict[str, np.ndarray]", size: int, fp: str,
               row: np.ndarray) -> None:
    cache[fp] = row
    cache.move_to_end(fp)
    while len(cache) > size:
        cache.popitem(last=False)


@dataclasses.dataclass
class _PendingJoin:
    """One admitted cache-miss awaiting its shard join.  Shared by
    every ticket that references the fingerprint (in-flight dedup);
    ``row`` is filled when the batch carrying it is fenced.  ``exact``
    goes False when the batch was fenced through the prescreen rung of
    the degradation ladder (a shard's host was down with no replica)."""

    fp: str
    seq: TRSeq
    enqueued: float                       # admission clock reading
    row: Optional[np.ndarray] = None
    exact: bool = True
    launched: bool = False                # set by the flush carrying it


@dataclasses.dataclass
class _InFlightBatch:
    """One flushed batch: its admitted entries and the per-shard
    ``InFlightRows`` handles, launched but not yet fenced.  ``down``
    collects the hosts whose launch already failed the retry ladder;
    the fence answers their column blocks via the failover ladder."""

    entries: List[_PendingJoin]
    handles: list                          # [(host, InFlightRows)]
    done: bool = False
    launched: float = 0.0                  # flush clock reading
    down: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _HostHealth:
    """Per-host circuit-breaker state the router tracks when a
    ``RetryPolicy`` is installed: ``closed`` (healthy), ``open``
    (short-circuit every call until the cooldown elapses), ``half_open``
    (cooldown elapsed, exactly one probe allowed - success closes and
    counts a recovery, failure re-opens)."""

    consec: int = 0
    state: str = "closed"
    opened_at: float = 0.0


class DrainTicket:
    """Handle for one ``ClusterRouter.submit`` drain: remembers the
    request shape (per-host fingerprints, arrival hosts) and how each
    fingerprint resolved (cached row / pending join / shed).  Redeem
    with ``ClusterRouter.collect``."""

    def __init__(self, k: int, created: float = 0.0):
        self.k = k
        self.created = created        # submit clock reading (e2e base)
        self.fps: Dict[int, List[str]] = {}
        self.arrival_hosts: Dict[str, set] = {}
        self.rows: Dict[str, object] = {}   # row | _PendingJoin | None
        self.cached: Dict[str, bool] = {}
        self.shed: Dict[str, TRSeq] = {}    # fps answered approximately
        self.results: Optional[Dict[int, List[QueryResult]]] = None

    @property
    def pending(self) -> int:
        """Referenced joins not yet fenced (0 = collect won't block)."""
        return sum(
            1 for v in self.rows.values()
            if isinstance(v, _PendingJoin) and v.row is None
        )

    @property
    def queued(self) -> int:
        """Referenced joins admitted but not yet launched by a flush
        (0 = collect fences only, it forces no flush).  Reading it
        flushes nothing: a client that collects a ticket only once this
        is 0 leaves every batch to the ``flush_batch`` / ``max_wait``
        triggers."""
        return sum(
            1 for v in self.rows.values()
            if isinstance(v, _PendingJoin) and not v.launched
        )


class ClusterRouter:
    """Batches queries arriving on different hosts into shared per-shard
    device batches and merges the per-shard rows (see the module
    docstring for the protocol)."""

    def __init__(
        self,
        hosts: Sequence,           # ClusterHost duck-types, shard order
        *,
        n_patterns: int,
        support: np.ndarray,       # live scoring supports, global order
        topk: int = 10,
        metrics: Optional[MetricsRegistry] = None,
        metrics_ns: str = "cluster.router",
        max_wait: Optional[float] = None,
        flush_batch: Optional[int] = None,
        shed_depth: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        fault_policy: Optional[RetryPolicy] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        self.hosts = list(hosts)
        self.n_patterns = n_patterns
        self.support = support
        self.topk = topk
        self._row_mask: Optional[np.ndarray] = None  # None = all active
        # --- admission pipeline knobs (see module docstring) ---
        # max_wait: deadline flush - seconds the head-of-queue may wait
        # flush_batch: batch flush - queue length that triggers a flush
        # shed_depth: queue+in-flight depth past which new misses get
        #   prescreen-only approximate answers (None = never shed)
        # clock: injectable monotonic clock (tests drive a fake one)
        self.max_wait = max_wait
        self.flush_batch = flush_batch
        self.shed_depth = shed_depth
        self.clock = time.monotonic if clock is None else clock
        self._queue: List[_PendingJoin] = []     # admission order
        self._pending: Dict[str, _PendingJoin] = {}  # queued+in-flight
        self._batches: List[_InFlightBatch] = []     # launch order
        self._tickets: List[DrainTicket] = []        # uncollected
        # registry-backed: pass ``metrics=`` to keep accumulating across
        # router rebuilds (the sharded streaming bank re-plans placement
        # on every full refresh; its hit counters must survive that)
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.stats = self.metrics.view(metrics_ns, keys=[
            "queries", "l1_hits", "l2_hits", "misses",
            "shard_batches", "mask_patches", "mask_clears",
            "inflight_hits", "shed_prescreen",
            "flush_batch", "flush_deadline", "flush_force",
        ])
        self._depth_gauge = self.metrics.gauge(
            f"{metrics_ns}.queue_depth")
        # always-on latency percentiles over the admission pipeline
        # (log-bucket histograms; observed against the injectable
        # ``self.clock`` so the pipeline tests can fake time):
        #   e2e_seconds        submit -> collected, per ticket
        #   queue_wait_seconds admit -> flush launch, per miss
        #   flush_seconds      flush launch -> batch fenced
        #   route_seconds      one synchronous route() drain
        self._h_e2e = self.metrics.bucket_histogram(
            f"{metrics_ns}.e2e_seconds")
        self._h_queue_wait = self.metrics.bucket_histogram(
            f"{metrics_ns}.queue_wait_seconds")
        self._h_flush = self.metrics.bucket_histogram(
            f"{metrics_ns}.flush_seconds")
        self._h_route = self.metrics.bucket_histogram(
            f"{metrics_ns}.route_seconds")
        # aging gauges the SLO watchdog reads: seconds the current
        # head-of-queue / oldest uncollected ticket have been waiting
        self._age_gauge = self.metrics.gauge(
            f"{metrics_ns}.queue_age")
        self._ticket_age_gauge = self.metrics.gauge(
            f"{metrics_ns}.oldest_ticket_age")
        # pre-registered so healthy snapshots carry an explicit 0
        self.metrics.counter(f"{metrics_ns}.slo_breaches")
        # optional SloWatchdog (obs.slo), driven from _note_depth -
        # every submit/poll/collect gives it a rate-limited check
        self.watchdog = None
        # --- fault semantics (serving.faults) ---
        # fault_policy: per-call timeout + retry/backoff + circuit
        #   breaker at every host call; None = the pre-fault fast path
        #   (h.call direct, zero added work, bit-identical behavior)
        # sleep: injectable backoff sleep (tests advance a fake clock)
        self.fault_policy = fault_policy
        self._sleep = sleep if sleep is not None else (
            time.sleep if clock is None else (lambda s: None))
        self._health: Dict[int, _HostHealth] = {}
        self._failover: Dict[int, Callable] = {}
        # per-host req-row mirrors (re-masked in lockstep with
        # apply_row_mask): the bottom rung of the degradation ladder
        # answers a dead shard's columns from the host-side counts
        # prescreen computed router-side, no host call at all
        self._req_base = {
            h.hid: np.array(
                h.server.bank.req[: h.server.bank.n_patterns],
                np.int32, copy=True)
            for h in self.hosts
        }
        self._req_mirror = dict(self._req_base)
        self._nlk = (self.hosts[0].server.bank.n_label_keys
                     if self.hosts else 1)
        # pre-registered (explicit 0 in healthy snapshots; the
        # breaker-open SLO rule reads these): the fault counters are a
        # fixed global namespace, not per-router, matching the
        # injector's own ``cluster.faults.injected``
        self.faults = self.metrics.view("cluster.faults", keys=[
            "injected", "retries", "breaker_open",
            "failovers", "degraded_answers", "recoveries",
        ])
        self._h_retry = self.metrics.bucket_histogram(
            "cluster.faults.retry_seconds")

    # ------------------------------------------------------------- cache
    def owner(self, fp: str) -> int:
        """The L2 owner host of a fingerprint (stable hash of the hex
        digest, so every host agrees without coordination)."""
        return int(fp[:8], 16) % len(self.hosts)

    def clear_caches(self) -> None:
        for h in self.hosts:
            h.l1.clear()
            h.l2.clear()

    def apply_row_mask(self, active: Optional[np.ndarray]) -> None:
        """Reconcile the L1/L2 caches with a new tombstone mask
        *per-row* instead of dropping them wholesale.  A masked bank row
        answers False by definition (see ``PatternServer.set_row_mask``),
        so a pure tombstone - rows only *leaving* the active set - can
        patch every cached containment row in place: newly-masked
        columns go False, untouched columns stay exact, and the entries
        (plus their LRU positions) survive.  Rows coming *back*
        (masked -> active) were cached as False with no way to recover
        the true bit, so any recovery still clears everything - the
        sound fallback.  Patches are copy-on-write: previously returned
        ``QueryResult.contained`` arrays may alias cache entries.

        The admission pipeline must be quiescent: an in-flight join was
        launched against the pre-mask requirements and its ticket holds
        references the patch cannot reach - collect every ticket before
        re-masking.  Raises ``PipelineBusyError`` (a typed error, not a
        bare assert - it must survive ``python -O``) naming the counts
        still in the pipeline."""
        if self._tickets or self._queue or self._batches:
            raise PipelineBusyError(
                queued=len(self._queue),
                inflight=sum(len(b.entries) for b in self._batches),
                tickets=len(self._tickets),
            )
        old = self._row_mask
        new = (None if active is None
               else np.asarray(active, bool).copy())
        self._row_mask = new
        old_a = (np.ones(self.n_patterns, bool) if old is None else old)
        new_a = (np.ones(self.n_patterns, bool) if new is None else new)
        # keep the degraded-path req mirrors in lockstep: masked rows
        # answer False from the prescreen too (their req is REQ_MASKED)
        for h in self.hosts:
            m = self._req_base[h.hid].copy()
            m[~new_a[h.rows]] = REQ_MASKED
            self._req_mirror[h.hid] = m
        if (new_a & ~old_a).any():  # recoveries: cached False is stale
            self.clear_caches()
            self.stats["mask_clears"] += 1
            return
        newly_masked = old_a & ~new_a
        if not newly_masked.any():
            return  # mask unchanged: every entry is still exact
        for h in self.hosts:
            for cache in (h.l1, h.l2):
                for fp, row in cache.items():
                    patched = row.copy()
                    patched[newly_masked] = False
                    cache[fp] = patched
        self.stats["mask_patches"] += 1

    # ----------------------------------------------------- fault ladder
    def _host_call(self, h, fn, *args):
        """Every cross-host access goes through here.  Without a
        ``fault_policy`` this is exactly ``h.call`` - the pre-fault
        fast path, bit-identical behavior.  With one, it is the retry
        ladder: per-call timeout on the injectable clock (a timed-out
        result is discarded), capped exponential backoff retries, and
        the per-host circuit breaker (open hosts short-circuit without
        a call; after the cooldown one half-open probe is allowed, and
        a successful probe recovers the host - caches wiped, since a
        restarted host's caches are gone).  Exhausted ladders raise
        ``HostUnavailableError``; the *caller* decides whether to fail
        over (replica / prescreen) or propagate."""
        pol = self.fault_policy
        if pol is None:
            return h.call(fn, *args)
        hh = self._health.setdefault(h.hid, _HostHealth())
        if hh.state == "open":
            if self.clock() - hh.opened_at < pol.breaker_cooldown:
                raise HostUnavailableError(
                    h.hid, f"host {h.hid} circuit breaker open")
            hh.state = "half_open"
        last: Optional[BaseException] = None
        attempts = 1 if hh.state == "half_open" else pol.retries + 1
        for attempt in range(attempts):
            t0 = self.clock()
            try:
                out = h.call(fn, *args)
                if (pol.call_timeout is not None
                        and self.clock() - t0 > pol.call_timeout):
                    raise HostTimeoutError(
                        h.hid,
                        f"host {h.hid} call exceeded "
                        f"{pol.call_timeout}s; result discarded")
            except HostFault as f:
                last = f
                trace.mark("host_fault")
                self._h_retry.observe(self.clock() - t0)
                if self._note_host_failure(hh) \
                        or attempt == attempts - 1:
                    break
                self.faults["retries"] += 1
                self._sleep(min(pol.backoff_base * 2.0 ** attempt,
                                pol.backoff_cap))
                continue
            if hh.state == "half_open":
                self._recover_host(h)
            hh.consec = 0
            hh.state = "closed"
            return out
        raise HostUnavailableError(h.hid, str(last)) from last

    def _note_host_failure(self, hh: _HostHealth) -> bool:
        """Count one failure; open the breaker (returns True) when the
        consecutive-failure threshold is hit or a half-open probe
        failed."""
        hh.consec += 1
        if (hh.state == "half_open"
                or hh.consec >= self.fault_policy.breaker_threshold):
            hh.state = "open"
            hh.opened_at = self.clock()
            self.faults["breaker_open"] += 1
            return True
        return False

    def _recover_host(self, h) -> None:
        """A half-open probe succeeded: the host rejoins routing.  Its
        caches are wiped - a really-restarted host would come back
        empty, and a stale entry served as fresh would break the
        exactness contract."""
        h.l1.clear()
        h.l2.clear()
        self.faults["recoveries"] += 1

    def set_failover_replica(self, hid: int, rows_fn: Callable) -> None:
        """Register the replica rung of the degradation ladder for one
        host: ``rows_fn(seqs) -> [len(seqs), n_patterns]`` exact
        containment rows in *global* bank order (e.g. a ReplicaGroup
        read replica's ``exact_rows`` - it holds the full bank).  While
        ``hid`` is unavailable its column block is answered from the
        replica, bit-equal and still ``exact=True``; hosts without one
        fall through to the prescreen, flagged ``exact=False``."""
        self._failover[hid] = rows_fn

    def _failover_rows(self, h, seqs: Sequence[TRSeq]):
        """Answer one down host's column block: replica if registered
        (exact), else the router-side counts prescreen over the host's
        req mirror (sound superset, inexact).  Returns
        ``(block [len(seqs), len(h.rows)], exact)``."""
        trace.mark("host_fault")
        fb = self._failover.get(h.hid)
        if fb is not None:
            rows = np.asarray(fb(seqs), bool)
            self.faults["failovers"] += 1
            return rows[:, h.rows], True
        self.faults["degraded_answers"] += len(seqs)
        block = prescreen_rows(
            list(seqs), self._req_mirror[h.hid], self._nlk)
        return block[:, : len(h.rows)], False

    # -------------------------------------------------------------- join
    def _live_hosts(self) -> List:
        return [h for h in self.hosts if len(h.rows)]

    def _shard_rows_ex(self, seqs: Sequence[TRSeq]):
        """The fault-aware core of ``joined_rows``: merged containment
        rows plus an exactness verdict.  Hosts whose launch or fence
        exhausts the retry ladder drop to the failover ladder for their
        column block; ``exact`` goes False iff any block came from the
        prescreen rung."""
        out = np.zeros((len(seqs), self.n_patterns), bool)
        exact = True
        live = self._live_hosts()
        if not len(seqs) or not live:
            return out, exact
        cap = min(h.server.max_batch for h in live)
        with trace.span("cluster.join", n=len(seqs)):
            for c0 in range(0, len(seqs), cap):
                chunk = list(seqs[c0 : c0 + cap])
                shared = _encodings(chunk, live)
                launched, down = [], []
                for h in live:
                    try:
                        launched.append((h, self._host_call(
                            h, h.server.launch_rows, chunk,
                            shared[h.server.device])))
                    except HostUnavailableError:
                        down.append(h)
                for h, flight in launched:
                    try:
                        shard = self._host_call(
                            h, h.server.finalize_rows, flight)
                    except HostUnavailableError:
                        down.append(h)
                        continue
                    out[c0 : c0 + len(chunk), h.rows] = \
                        shard[:, : len(h.rows)]
                for h in down:
                    block, ok = self._failover_rows(h, chunk)
                    out[c0 : c0 + len(chunk), h.rows] = \
                        block[:, : len(h.rows)]
                    exact = exact and ok
            self.stats["shard_batches"] += len(live)
        return out, exact

    def joined_rows(self, seqs: Sequence[TRSeq]) -> np.ndarray:
        """Cache-bypassing merged containment rows [len(seqs),
        n_patterns], rows scattered back into global bank order.  The
        queries are encoded ONCE (``encode_queries``) and every shard's
        join is launched before any is fenced - per-shard cost is the
        shard's own group joins, not a full re-encode, and the shards'
        device batches overlap.  Zero collectives - the shard outputs
        are disjoint column blocks.

        This entry point has a *strict* exactness contract (the
        streaming window protocol reconciles supports through it): if a
        shard's host is unavailable and no replica covers it, it raises
        ``HostUnavailableError`` rather than return prescreen bits.
        Query-serving paths (``route``/``submit``/``collect``) use the
        degrading ``_shard_rows_ex`` instead."""
        rows, exact = self._shard_rows_ex(seqs)
        if not exact:
            raise HostUnavailableError(
                -1, "exact join impossible: a shard's host is "
                    "unavailable and no replica covers it")
        return rows

    # ------------------------------------------------------------- route
    def _score(self, row: np.ndarray, k: int) -> List[tuple]:
        return score_topk(row, self.support, k)

    def route(
        self,
        requests: Mapping[int, Sequence[TRSeq]],
        k: Optional[int] = None,
    ) -> Dict[int, List[QueryResult]]:
        """Serve one drain of the cluster-wide request queue:
        ``requests`` maps arrival host id -> its pending sequences.
        Returns per-host results in request order, bit-equal to a
        single-host ``PatternServer.query`` over the unsharded bank."""
        k = self.topk if k is None else k
        t_r0 = self.clock()
        try:
            return self._route_inner(requests, k)
        finally:
            self._h_route.observe(self.clock() - t_r0)

    def _route_inner(
        self,
        requests: Mapping[int, Sequence[TRSeq]],
        k: int,
    ) -> Dict[int, List[QueryResult]]:
        with trace.root_or_span(
                "cluster.route",
                n=sum(len(s) for s in requests.values())):
            fps: Dict[int, List[str]] = {}
            rows: Dict[str, Optional[np.ndarray]] = {}
            cached: Dict[str, bool] = {}
            arrival_hosts: Dict[str, set] = {}
            miss_fps: List[str] = []
            miss_seqs: List[TRSeq] = []
            with trace.span("cluster.cache", cat="cache"):
                for hid, seqs in requests.items():
                    host = self.hosts[hid]
                    fps[hid] = hfps = [
                        sequence_fingerprint(s) for s in seqs
                    ]
                    self.stats["queries"] += len(seqs)
                    for fp, s in zip(hfps, seqs):
                        arrival_hosts.setdefault(fp, set()).add(hid)
                        if fp in rows:
                            continue
                        if fp in host.l1:
                            host.l1.move_to_end(fp)
                            rows[fp] = host.l1[fp]
                            cached[fp] = True
                            self.stats["l1_hits"] += 1
                            continue
                        own = self.hosts[self.owner(fp)]
                        if fp in own.l2:
                            own.l2.move_to_end(fp)
                            rows[fp] = own.l2[fp]
                            cached[fp] = True
                            self.stats["l2_hits"] += 1
                            continue
                        rows[fp] = None  # placeholder: first-seen order
                        cached[fp] = False
                        miss_fps.append(fp)
                        miss_seqs.append(s)
            exact = dict.fromkeys(rows, True)
            if miss_seqs:
                self.stats["misses"] += len(miss_seqs)
                # degrading join: a dead shard's block falls to the
                # failover ladder instead of failing the whole drain
                got, ok = self._shard_rows_ex(miss_seqs)
                with trace.span("cluster.cache_fill", cat="cache"):
                    for i, fp in enumerate(miss_fps):
                        rows[fp] = got[i]
                        exact[fp] = ok
                        if ok:  # inexact rows are never cached
                            own = self.hosts[self.owner(fp)]
                            _cache_put(own.l2, own.l2_size, fp, got[i])
            with trace.span("cluster.finalize"):
                # every exactly-resolved fingerprint lands in its
                # arrival hosts' L1s; degraded rows stay uncached (a
                # later lookup must not serve them as exact)
                for fp, hids in arrival_hosts.items():
                    if not exact[fp]:
                        continue
                    for hid in hids:
                        host = self.hosts[hid]
                        _cache_put(host.l1, host.l1_size, fp, rows[fp])
                return {
                    hid: [
                        QueryResult(
                            fingerprint=fp, contained=rows[fp],
                            topk=self._score(rows[fp], k),
                            cached=cached[fp],
                            exact=exact[fp],
                        )
                        for fp in fps[hid]
                    ]
                    for hid in requests
                }

    def join(self, req) -> "JoinResult":
        """The unified entry point (serving.join): exact requests run
        one synchronous drain (``route``) for the arrival host;
        ``exact=False`` requests serve the merged shard prescreen (the
        shed tier's rows on demand), flagged inexact and never
        cached."""
        from .join import JoinResult, join_span
        seqs = list(req.seqs)
        with join_span(req, "router"):
            if req.exact:
                return JoinResult(
                    self.route({req.host: seqs}, k=req.k)[req.host])
            k = self.topk if req.k is None else req.k
            self.stats["queries"] += len(seqs)
            self.stats["shed_prescreen"] += len(seqs)
            approx = self._approx_rows(seqs)
            return JoinResult([
                QueryResult(
                    fingerprint=sequence_fingerprint(s),
                    contained=approx[i], topk=self._score(approx[i], k),
                    cached=False, exact=False,
                )
                for i, s in enumerate(seqs)
            ])

    # --------------------------------------------- admission pipeline
    def depth(self) -> int:
        """Misses admitted but not yet fenced: queued + in flight."""
        return len(self._queue) + sum(
            len(b.entries) for b in self._batches if not b.done
        )

    def attach_watchdog(self, watchdog) -> None:
        """Wire an ``obs.slo.SloWatchdog``: ``_note_depth`` (already on
        every submit/poll/collect) will give it rate-limited checks."""
        self.watchdog = watchdog

    def _note_depth(self) -> None:
        self._depth_gauge.set(self.depth())
        now = self.clock()
        self._age_gauge.set(
            now - self._queue[0].enqueued if self._queue else 0.0)
        self._ticket_age_gauge.set(
            now - min(t.created for t in self._tickets)
            if self._tickets else 0.0)
        if self.watchdog is not None:
            self.watchdog.maybe_check()

    def submit(
        self,
        requests: Mapping[int, Sequence[TRSeq]],
        k: Optional[int] = None,
    ) -> DrainTicket:
        """Admit one drain without blocking: resolve the two-level
        cache exactly like ``route``, piggyback on queued/in-flight
        duplicates, shed to the approximate tier past ``shed_depth``,
        enqueue the rest, and fire any flush trigger.  Returns a ticket
        for ``collect``; the queued joins run on device while later
        drains keep submitting."""
        k = self.topk if k is None else k
        ticket = DrainTicket(k, created=self.clock())
        with trace.root_or_span(
                "cluster.submit",
                n=sum(len(s) for s in requests.values())):
            with trace.span("cluster.cache", cat="cache"):
                for hid, seqs in requests.items():
                    host = self.hosts[hid]
                    ticket.fps[hid] = hfps = [
                        sequence_fingerprint(s) for s in seqs
                    ]
                    self.stats["queries"] += len(seqs)
                    for fp, s in zip(hfps, seqs):
                        ticket.arrival_hosts.setdefault(
                            fp, set()).add(hid)
                        if fp in ticket.rows:
                            continue
                        if fp in host.l1:
                            host.l1.move_to_end(fp)
                            ticket.rows[fp] = host.l1[fp]
                            ticket.cached[fp] = True
                            self.stats["l1_hits"] += 1
                            continue
                        own = self.hosts[self.owner(fp)]
                        if fp in own.l2:
                            own.l2.move_to_end(fp)
                            ticket.rows[fp] = own.l2[fp]
                            ticket.cached[fp] = True
                            self.stats["l2_hits"] += 1
                            continue
                        pend = self._pending.get(fp)
                        if pend is not None:
                            # an earlier drain already admitted this
                            # fingerprint and it is queued or on
                            # device: share its row, no second join
                            ticket.rows[fp] = pend
                            ticket.cached[fp] = False
                            self.stats["inflight_hits"] += 1
                            continue
                        self.stats["misses"] += 1
                        if (self.shed_depth is not None
                                and self.depth() >= self.shed_depth):
                            # overload: prescreen-only answer at
                            # collect time, flagged inexact, uncached
                            ticket.shed[fp] = s
                            ticket.rows[fp] = None
                            ticket.cached[fp] = False
                            self.stats["shed_prescreen"] += 1
                            trace.mark("shed")
                            continue
                        pend = _PendingJoin(fp, s, self.clock())
                        self._queue.append(pend)
                        self._pending[fp] = pend
                        ticket.rows[fp] = pend
                        ticket.cached[fp] = False
            self._tickets.append(ticket)
            self._maybe_flush()
            self._note_depth()
        return ticket

    def poll(self) -> None:
        """Deadline pump: flush the queue if its head has waited past
        ``max_wait``.  Call between submits when arrivals are sparse -
        submit/collect fire the same check themselves."""
        self._maybe_flush()
        self._note_depth()

    def _maybe_flush(self) -> None:
        while self._queue:
            if (self.flush_batch is not None
                    and len(self._queue) >= self.flush_batch):
                self._flush("batch")
            elif (self.max_wait is not None
                    and self.clock() - self._queue[0].enqueued
                    >= self.max_wait):
                self._flush("deadline")
            else:
                break

    def _flush(self, reason: str) -> None:
        """Launch the head of the queue as one batch per shard (shared
        query encoding, ``launch_rows``) - dispatch only, no fence: the
        joins compute while the pipeline keeps admitting."""
        live = self._live_hosts()
        cap = min((h.server.max_batch for h in live),
                  default=len(self._queue))
        batch = self._queue[:cap]
        del self._queue[:cap]
        seqs = [e.seq for e in batch]
        t_launch = self.clock()
        for e in batch:
            self._h_queue_wait.observe(t_launch - e.enqueued)
            e.launched = True
        # a root where no trace is open: a deadline flush fired by
        # ``poll`` is recorded like one fired inside ``submit``
        with trace.root_or_span("cluster.flush", reason=reason,
                                n=len(seqs)):
            handles, down = [], []
            if live:
                shared = _encodings(seqs, live)
                for h in live:
                    try:
                        handles.append((h, self._host_call(
                            h, h.server.launch_rows, seqs,
                            shared[h.server.device])))
                    except HostUnavailableError:
                        # launch already exhausted the ladder: the
                        # fence answers this host's block via failover
                        down.append(h)
            self.stats["shard_batches"] += len(handles)
        self._batches.append(
            _InFlightBatch(entries=batch, handles=handles,
                           launched=t_launch, down=down))
        self.stats["flush_" + reason] += 1

    def _fence_batch(self, batch: _InFlightBatch) -> None:
        """Fence one in-flight batch and fill the owner L2s - the
        async analogue of ``route``'s post-join cache fill, same order:
        batch entries in admission order, L2 before any ticket's L1."""
        with trace.span("cluster.fence", n=len(batch.entries)):
            rows = np.zeros((len(batch.entries), self.n_patterns), bool)
            down = list(batch.down)
            for h, flight in batch.handles:
                try:
                    shard = self._host_call(
                        h, h.server.finalize_rows, flight)
                except HostUnavailableError:
                    down.append(h)
                    continue
                rows[:, h.rows] = shard[:, : len(h.rows)]
            exact = True
            if down:
                seqs = [e.seq for e in batch.entries]
                for h in down:
                    block, ok = self._failover_rows(h, seqs)
                    rows[:, h.rows] = block[:, : len(h.rows)]
                    exact = exact and ok
            with trace.span("cluster.cache_fill", cat="cache"):
                for i, e in enumerate(batch.entries):
                    e.row = rows[i]
                    e.exact = exact
                    if exact:  # degraded rows are never cached
                        own = self.hosts[self.owner(e.fp)]
                        _cache_put(own.l2, own.l2_size, e.fp, rows[i])
                    self._pending.pop(e.fp, None)
        self._h_flush.observe(self.clock() - batch.launched)
        batch.done = True

    def _approx_rows(self, seqs: Sequence[TRSeq]) -> np.ndarray:
        """Merged prescreen-only rows for the shed tier: each shard's
        host-side counts prescreen, global bank order, no device.  An
        unavailable host costs nothing here - the prescreen needs no
        host state, so the router computes the same bits from its req
        mirror."""
        out = np.zeros((len(seqs), self.n_patterns), bool)
        with trace.span("cluster.approx", n=len(seqs)):
            for h in self._live_hosts():
                try:
                    shard = self._host_call(h, h.server.approx_rows,
                                            seqs)
                except HostUnavailableError:
                    shard = prescreen_rows(
                        list(seqs), self._req_mirror[h.hid], self._nlk)
                out[:, h.rows] = shard[:, : len(h.rows)]
        return out

    def collect(
        self, ticket: Optional[DrainTicket] = None,
        timeout: Optional[float] = None,
    ) -> "Dict[int, List[QueryResult]] | List[Dict[int, List[QueryResult]]]":
        """Redeem one ticket (or, with ``None``, every outstanding
        ticket in submit order).  Force-flushes and fences in admission
        order until the ticket's joins are resolved, computes the shed
        tier's approximate rows, fills arrival-host L1s, and returns
        the per-host results - bit-equal to ``route`` on the same
        requests wherever ``exact`` is True.

        ``timeout`` bounds the drain on the injectable clock: once the
        deadline passes, joins still unresolved are *degraded* through
        the shed tier (prescreen answer, ``exact=False``) instead of
        blocking forever on a lost or faulting in-flight batch - every
        query still gets exactly one answer.  The timed-out joins stay
        queued/in flight and resolve exactly on a later fence; a repeat
        submit of the same fingerprint piggybacks on them."""
        if ticket is None:
            return [self.collect(t, timeout=timeout)
                    for t in list(self._tickets)]
        if ticket.results is not None:
            return ticket.results
        deadline = (None if timeout is None
                    else self.clock() + timeout)
        with trace.root_or_span("cluster.collect"):
            while ticket.pending:
                if deadline is not None and self.clock() >= deadline:
                    # deadline passed with joins unresolved: answer the
                    # stragglers from the shed tier, leave their joins
                    # in the pipeline to finish exactly later
                    for fp, v in list(ticket.rows.items()):
                        if isinstance(v, _PendingJoin) \
                                and v.row is None:
                            ticket.shed[fp] = v.seq
                            ticket.rows[fp] = None
                            self.stats["shed_prescreen"] += 1
                            trace.mark("shed")
                    break
                if self._batches:
                    self._fence_batch(self._batches.pop(0))
                    continue
                if not self._queue:
                    # not queued, not in flight, row never filled: the
                    # batch carrying it was lost.  A typed error, not
                    # an assert - this must survive ``python -O``.
                    raise RuntimeError(
                        "pending join neither queued nor in flight")
                self._flush("force")
            self._note_depth()
            with trace.span("cluster.finalize"):
                rows: Dict[str, np.ndarray] = {}
                exact: Dict[str, bool] = {}
                for fp, v in ticket.rows.items():
                    if fp in ticket.shed:
                        continue
                    if isinstance(v, _PendingJoin):
                        rows[fp] = v.row
                        exact[fp] = v.exact
                    else:
                        rows[fp] = v
                        exact[fp] = True
                if ticket.shed:
                    trace.mark("shed")
                    shed_fps = list(ticket.shed)
                    approx = self._approx_rows(
                        [ticket.shed[fp] for fp in shed_fps])
                    for i, fp in enumerate(shed_fps):
                        rows[fp] = approx[i]
                        exact[fp] = False
                # exact rows land in their arrival hosts' L1s, same as
                # route; approximate rows are never cached (a later
                # lookup must not serve them as exact)
                for fp, hids in ticket.arrival_hosts.items():
                    if not exact[fp]:
                        continue
                    for hid in hids:
                        host = self.hosts[hid]
                        _cache_put(host.l1, host.l1_size, fp, rows[fp])
                ticket.results = {
                    hid: [
                        QueryResult(
                            fingerprint=fp, contained=rows[fp],
                            topk=self._score(rows[fp], ticket.k),
                            cached=ticket.cached[fp],
                            exact=exact[fp],
                        )
                        for fp in ticket.fps[hid]
                    ]
                    for hid in ticket.fps
                }
        self._h_e2e.observe(self.clock() - ticket.created)
        self._tickets.remove(ticket)
        self._note_depth()
        return ticket.results
