"""Multi-host serving cluster: sharded bank, routed queries, and the
sharded-window streaming protocol.

GTRACE-RS decomposes the pattern space into independent reverse-search
subtrees, so the mined bank shards with *zero cross-shard joins*; this
module lifts that to a cluster of simulated hosts in one process.
Three topologies:

* ``ServingCluster`` - a static bank split across hosts
  (``router.plan_placement``: depth-1 trie subtrees stay intact per
  host; flat banks split by pattern range).  Queries arrive on any
  host; ``ClusterRouter`` drains them together, resolves the two-level
  cache (host-local L1, fingerprint-owner L2 - both keyed by the
  renaming-invariant ``sequence_fingerprint``), batches the misses into
  shared pow-2 device batches per shard, and merges per-shard rows into
  global bank order.  Routed answers (containment bits, top-k, resolved
  overflow) are bit-equal to a single-host ``PatternServer``.

* ``ShardedStreamingBank`` - the sharded-window protocol.  Each host
  owns a *slice of the ring buffer* (arrival ``i`` lands on host ``i %
  n_hosts``, so the union of slices is always the window's most recent
  ``window`` sequences) plus its bank shard.  An arrival is joined once
  against every bank shard *on the shard's owner* (the routed
  containment batch), and the merged row is stored on the arrival's
  ring owner, which maintains *partial* supports - increments on
  arrival, decrements from the stored bitmap on eviction, no re-join.
  ``refresh()`` is the only synchronisation point: partial supports are
  **all-reduced** (summed across ring slices - exact because the slices
  partition the window, the Campagna-Pagh stream decomposition), the
  per-child dirtiness index is all-reduced at depth-1-subtree
  granularity (O(#subtrees) flags per host instead of a bank-width bit
  row; sound because dirt is anti-monotone up the parent chain), and
  the incremental frontier re-mine + tombstone cut run against exact
  global supports.  Between refreshes nothing is masked, so per-host
  partial supports stay exact for every active row; post-refresh the
  frequent map is bit-equal to a batch re-mine of the window (and hence
  to the single-host ``StreamingBank`` on the same arrivals).

* ``ReplicaGroup`` - single-writer / read-replica mode.  One writer
  runs the ordinary ``StreamingBank`` (observe / tombstone / refresh);
  replicas serve the masked bank and apply the writer's shipped deltas
  (``StreamingBank.delta_sink``): support updates, tombstone masks, and
  - after an incremental refresh - ``extend_bank``/``extend_trie``
  appends instead of a recompile.  Until a replica syncs it keeps
  serving its previous masked bank, so reads never block on a writer
  refresh.

Choosing between the streaming topologies: **read replicas** scale
*query* throughput (every replica serves the whole bank; arrivals still
funnel through the one writer) and replicas lag by the unshipped
deltas.  The **sharded window** scales *arrival* throughput too (the
per-arrival join fans out across shards, ring upkeep is per-host) and
serves exact containment at every moment, but support freshness for
tombstoning is per-refresh, and every query touches all shards.  Use
replicas for read-heavy/low-churn traffic, the sharded window when the
arrival stream itself is the load.

Hosts are an abstraction: ``ClusterHost.call`` is the host boundary.
The in-process ``ClusterHost`` is pinned to one ``torch.device``: host
``hid`` serves on ``devices[hid % len(devices)]``, and by default every
host shares one device - the card, or the CPU when ``device="cpu"`` is
asked for.  Its shard server, and so every kernel launch of its joins,
runs there.  A ``torch.distributed``-style process group would
implement the same interface with RPCs.  The sharded window's
"all-reduces" are host sums over the ring slices (no collective library
is involved).  Everything above the boundary is testable on the CPU:
after any routed batch or sharded refresh, results and the frequent
map must be bit-equal to the single-host ``PatternServer`` /
``StreamingBank`` on the same inputs and to the JAX package's cluster
(tests/test_torch_cluster.py).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.graphseq import Pattern, TRSeq
from ..kernels import DeviceLike, resolve_device
from ..mining.driver import AcceleratedMiner
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from ..mining.incremental import depth1_root, refresh_frontier, \
    subtree_dirty_rows
from .bank import BankCapacityError, PatternBank, compile_bank, \
    extend_bank, slice_bank
from .faults import HostDownError, RecoveryLog
from .layouts import get_layout
from .router import BankPlacement, ClusterRouter, plan_placement
from .server import PatternServer, QueryResult, score_topk
from .streaming import StreamingBank
from .trie import TrieBank, build_trie, extend_trie


@dataclasses.dataclass
class ClusterHost:
    """One simulated host: its bank shard server, owned global rows,
    and the two cache levels.  ``call`` is the host boundary - every
    cross-host access in this module goes through it.  An installed
    ``FaultInjector`` (serving.faults) is consulted *before* the
    wrapped function runs, so an injected fault never half-executes a
    call - exactly the semantics of a dropped RPC."""

    hid: int
    rows: np.ndarray               # owned global bank rows
    server: PatternServer          # over slice_bank(bank, rows)
    l1: "OrderedDict[str, np.ndarray]"
    l2: "OrderedDict[str, np.ndarray]"
    l1_size: int
    l2_size: int
    device: torch.device           # the shard server's device
    injector: Optional[object] = None  # FaultInjector (None = never)

    def call(self, fn, *args, **kw):
        if self.injector is not None:
            self.injector.on_call(self.hid)
        with trace.span("cluster.host_call", host=self.hid):
            return fn(*args, **kw)


def _host_devices(devices: Optional[Sequence[DeviceLike]],
                  device: DeviceLike) -> List[torch.device]:
    """The devices hosts are pinned to, round robin: ``devices`` when
    given, else the one ``device`` (``cuda`` unless given) for every
    host."""
    if devices is None:
        return [resolve_device(device)]
    if device is not None:
        raise ValueError("pass devices or device, not both")
    if not len(devices):
        raise ValueError("devices must name at least one device")
    return [resolve_device(d) for d in devices]


def _make_hosts(
    bank: PatternBank,
    placement: BankPlacement,
    *,
    bank_layout: str,
    l1_size: int,
    l2_size: int,
    devices: Sequence[torch.device],
    server_kw: Optional[dict] = None,
    metrics: Optional[MetricsRegistry] = None,
) -> List[ClusterHost]:
    hosts = []
    for hid, rows in enumerate(placement.rows):
        shard = slice_bank(bank, rows)
        device = devices[hid % len(devices)]
        # per-host namespaces on the shared registry: shard counters
        # stay separate (ServingCluster.stats sums them), yet survive
        # re-planning because the registry outlives the servers
        srv = PatternServer(shard, bank_layout=bank_layout,
                            metrics=metrics,
                            metrics_ns=f"serving.server.h{hid}",
                            device=device, **(server_kw or {}))
        hosts.append(ClusterHost(
            hid=hid, rows=rows, server=srv,
            l1=OrderedDict(), l2=OrderedDict(),
            l1_size=l1_size, l2_size=l2_size, device=device,
        ))
    return hosts


class ServingCluster:
    """A static pattern bank served by ``n_hosts`` hosts - see the
    module docstring for the placement/routing/caching protocol.  Host
    ``hid`` serves on ``devices[hid % len(devices)]``; with no
    ``devices``, every host serves on ``device`` (``cuda`` unless
    given)."""

    def __init__(
        self,
        bank: PatternBank,
        n_hosts: int,
        *,
        bank_layout: str = "flat",
        trie: Optional[TrieBank] = None,
        topk: int = 10,
        l1_size: int = 4096,
        l2_size: int = 8192,
        devices: Optional[Sequence[DeviceLike]] = None,
        device: DeviceLike = None,
        metrics: Optional[MetricsRegistry] = None,
        max_wait: Optional[float] = None,
        flush_batch: Optional[int] = None,
        shed_depth: Optional[int] = None,
        clock=None,
        injector=None,
        fault_policy=None,
        sleep=None,
        **server_kw,
    ):
        self.bank = bank
        self.n_hosts = n_hosts
        self.bank_layout = bank_layout
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.devices = _host_devices(devices, device)
        self._mk = dict(l1_size=l1_size, l2_size=l2_size,
                        devices=self.devices, server_kw=server_kw,
                        metrics=self.metrics)
        self.placement = plan_placement(
            bank, n_hosts, layout=bank_layout, trie=trie
        )
        self.hosts = _make_hosts(bank, self.placement,
                                 bank_layout=bank_layout, **self._mk)
        # fault semantics (serving.faults): the injector sits at every
        # host's call boundary; the policy arms the router's retry /
        # breaker / failover ladder.  Both default off - the pre-fault
        # fast path is bit-identical
        self.injector = injector
        if injector is not None:
            injector.bind(self.metrics)
            for h in self.hosts:
                h.injector = injector
        self.router = ClusterRouter(
            self.hosts, n_patterns=bank.n_patterns,
            support=bank.support[: bank.n_patterns].astype(np.int64),
            topk=topk, metrics=self.metrics,
            max_wait=max_wait, flush_batch=flush_batch,
            shed_depth=shed_depth, clock=clock,
            fault_policy=fault_policy, sleep=sleep,
        )

    # ------------------------------------------------------------ serving
    def join(self, req) -> "JoinResult":
        """The unified entry point (serving.join): delegates to the
        router, so exactness semantics (including the ``exact=False``
        approximate tier) are the router's."""
        return self.router.join(req)

    def query(
        self, seqs: Sequence[TRSeq], host: int = 0,
        k: Optional[int] = None,
    ) -> List[QueryResult]:
        """Queries arriving on one host."""
        from .join import JoinRequest
        return self.join(JoinRequest(
            seqs=tuple(seqs), k=k, host=host)).results

    def query_multi(
        self, requests: Mapping[int, Sequence[TRSeq]],
        k: Optional[int] = None,
    ) -> Dict[int, List[QueryResult]]:
        """One drain of queries that arrived on different hosts -
        misses share per-shard device batches."""
        return self.router.route(requests, k=k)

    def exact_rows(self, seqs: Sequence[TRSeq]) -> np.ndarray:
        """Cache-bypassing merged containment rows (global bank
        order)."""
        return self.router.joined_rows(seqs)

    # --------------------------------------------- async ingestion
    def submit(self, requests, k: Optional[int] = None):
        """Admit one drain into the continuous-batching pipeline
        without blocking (``ClusterRouter.submit``); redeem the
        returned ticket with ``collect``.  Configure the flush/shed
        policy via the constructor's ``max_wait`` / ``flush_batch`` /
        ``shed_depth``."""
        return self.router.submit(requests, k=k)

    def poll(self) -> None:
        """Deadline pump between sparse submits."""
        self.router.poll()

    def attach_watchdog(self, watchdog) -> None:
        """Wire an ``obs.slo.SloWatchdog`` into the admission pipeline
        (delegates to ``ClusterRouter.attach_watchdog``): every
        submit/poll/collect gives it a rate-limited rules check."""
        self.router.attach_watchdog(watchdog)

    def collect(self, ticket=None, timeout=None):
        """Fence + finalize one ticket (or all outstanding ones).
        ``timeout`` bounds the drain on the injectable clock: past the
        deadline, unresolved joins degrade through the shed tier
        (``exact=False``) instead of blocking forever - see
        ``ClusterRouter.collect``."""
        return self.router.collect(ticket, timeout=timeout)

    # ------------------------------------------------------- fault ladder
    def attach_failover_replica(self, hid: int, replica) -> None:
        """Register a ``BankReplica`` (over the FULL bank) as host
        ``hid``'s failover: while that host's breaker is open its
        column block is answered from the replica's cache-bypassing
        exact rows - bit-equal, still ``exact=True``.  Hosts without a
        registered replica degrade to the prescreen instead."""
        self.router.set_failover_replica(
            hid, lambda seqs: replica.server.exact_rows(seqs))

    # ------------------------------------------------------------ masking
    def set_row_mask(self, active: Optional[np.ndarray]) -> None:
        """Install a global tombstone mask: each shard server masks its
        slice of ``active``; the router reconciles its caches per-row
        (pure tombstones patch newly-dead columns in place, recoveries
        fall back to a full drop - see ``ClusterRouter.apply_row_mask``).
        The router goes first: its quiescence check (no uncollected
        tickets) must refuse before any shard server is touched."""
        self.router.apply_row_mask(active)
        for h in self.hosts:
            if not len(h.rows):
                continue
            h.call(h.server.set_row_mask,
                   None if active is None else active[h.rows])

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        """Router counters plus the summed shard-server counters."""
        out = dict(self.router.stats)
        for h in self.hosts:
            for key, val in h.server.stats.items():
                out[f"shards_{key}"] = out.get(f"shards_{key}", 0) + val
        return out


# --------------------------------------------------------------- streaming
@dataclasses.dataclass
class RingSlice:
    """Host-local sliding-window state: this host's slice of the ring
    (arrivals ``i`` with ``i % n_hosts == hid``), its per-sequence
    containment bitmaps, freshness flags (the slot-granular dirtiness
    index - see serving.streaming), and *partial* supports (column sums
    of the local bitmaps; the all-reduce at refresh sums them into
    exact global supports)."""

    bits: np.ndarray              # [w_local, P] bool
    seqs: List[Optional[TRSeq]]
    gidx: np.ndarray              # [w_local] int64 global arrival id, -1 empty
    fresh: np.ndarray             # [w_local] bool, written since reconcile
    psum: np.ndarray              # [P] int64 partial supports

    @classmethod
    def empty(cls, w_local: int, n_patterns: int) -> "RingSlice":
        return cls(
            bits=np.zeros((w_local, n_patterns), bool),
            seqs=[None] * w_local,
            gidx=np.full(w_local, -1, np.int64),
            fresh=np.zeros(w_local, bool),
            psum=np.zeros(n_patterns, np.int64),
        )

    def grow(self, n_patterns: int) -> None:
        pad = n_patterns - self.bits.shape[1]
        self.bits = np.pad(self.bits, ((0, 0), (0, pad)))
        self.psum = np.concatenate(
            [self.psum, np.zeros(pad, np.int64)])

    def reset_rows(self, n_patterns: int) -> None:
        """Drop all bitmaps/supports (full refresh recounts them); the
        stored sequences and arrival ids stay - the window itself is
        unchanged."""
        self.bits = np.zeros((self.bits.shape[0], n_patterns), bool)
        self.psum = np.zeros(n_patterns, np.int64)


class ShardedStreamingBank:
    """``StreamingBank`` under the sharded-window protocol (module
    docstring): ring slices + partial supports per host, one support
    all-reduce and one depth-1-subtree dirtiness all-reduce per
    ``refresh()``.  Tombstoning is *refresh-grained* (between refreshes
    nothing is masked, so partial supports stay exact for every active
    row); after any refresh the frequent map is bit-equal to a batch
    re-mine of the window."""

    def __init__(
        self,
        bank: PatternBank,
        *,
        n_hosts: int,
        window: int,
        minsup: int,
        bank_layout: str = "flat",
        max_len: Optional[int] = None,
        tombstones: bool = True,
        miner_kw: Optional[dict] = None,
        devices: Optional[Sequence[DeviceLike]] = None,
        device: DeviceLike = None,
        **server_kw,
    ):
        assert window > 0 and minsup > 0 and n_hosts > 0
        assert window % n_hosts == 0, \
            "window must divide evenly across ring slices"
        assert bank.n_rows == max(bank.n_patterns, 1), \
            "streaming requires an unpadded bank"
        self.window = window
        self.minsup = minsup
        self.n_hosts = n_hosts
        self.bank_layout = bank_layout
        self.max_len = max_len
        self.tombstones = tombstones
        self.devices = _host_devices(devices, device)
        # the re-mines run on the first host's device
        self.miner_kw = dict(miner_kw or {}, device=self.devices[0])
        self.server_kw = dict(server_kw)
        self.bank = bank
        self._w_local = window // n_hosts
        P = bank.n_patterns
        self.support = np.zeros(P, np.int64)  # last all-reduced view
        self.active = np.ones(P, bool)
        self.ring = [RingSlice.empty(self._w_local, P)
                     for _ in range(n_hosts)]
        self._t = 0  # global arrival counter
        self._any_change = False
        # one registry for the whole topology: the serving plane
        # (shard servers + router) is rebuilt on every re-plan, but its
        # counters re-attach here and accumulate - refresh(full=True)
        # no longer zeroes router hit rates
        self.metrics = MetricsRegistry()
        self.cluster = self._make_cluster()
        self.stats = self.metrics.view("streaming.sharded", keys=[
            "arrivals", "evictions", "observe_batches",
            "tombstoned", "recovered", "added",
            "refreshes", "full_refreshes",
            "allreduces", "dirty_subtrees",
            "frontier_scans", "frontier_scans_skipped",
            "frontier_retained",
        ])
        # always-on latency percentiles (mirror StreamingBank's)
        self._h_observe = self.metrics.bucket_histogram(
            "streaming.sharded.observe_seconds")
        self._h_refresh = self.metrics.bucket_histogram(
            "streaming.sharded.refresh_seconds")

    # ------------------------------------------------------------ wiring
    def _make_cluster(self) -> ServingCluster:
        return ServingCluster(
            self.bank, self.n_hosts, bank_layout=self.bank_layout,
            devices=self.devices, metrics=self.metrics,
            **self.server_kw,
        )

    def _rebuild_serving(self) -> None:
        """New bank -> new placement, shard servers, and router; the
        ring slices (window state) survive untouched."""
        self.cluster = self._make_cluster()
        self.cluster.router.support = self.support

    def _apply_mask(self) -> None:
        if not self.tombstones:
            return
        mask = None if self.active.all() else self.active
        self.cluster.set_row_mask(mask)

    @classmethod
    def from_db(
        cls,
        db: Sequence[TRSeq],
        *,
        minsup: int,
        n_hosts: int,
        window: Optional[int] = None,
        max_len: Optional[int] = None,
        miner_kw: Optional[dict] = None,
        devices: Optional[Sequence[DeviceLike]] = None,
        device: DeviceLike = None,
        **kw,
    ) -> "ShardedStreamingBank":
        """Mine ``db`` into a bank and stream it in as the seed window.
        The seed arrivals stay *fresh* (unlike ``StreamingBank.from_db``
        there is no tombstone cut at seed time - tombstoning is
        refresh-grained here), so the first refresh treats them as
        dirty; exactness is unaffected."""
        devices = _host_devices(devices, device)
        miner = AcceleratedMiner(db, **dict(miner_kw or {},
                                            device=devices[0]))
        result = miner.mine_rs(minsup, max_len=max_len)
        bank = compile_bank(result)
        w = window or max(len(db), 1)
        sb = cls(bank, n_hosts=n_hosts, window=w, minsup=minsup,
                 max_len=max_len, miner_kw=miner_kw, devices=devices,
                 **kw)
        sb.observe(db)
        return sb

    # ----------------------------------------------------------- streams
    @property
    def n_patterns(self) -> int:
        return self.bank.n_patterns

    def _window_slots(self) -> List[Tuple[int, int, int]]:
        """Occupied (global arrival id, host, slot) triples in window
        (oldest-first) order - the strict round-robin placement makes
        the union of slices exactly the last ``window`` arrivals."""
        items = []
        for hid, r in enumerate(self.ring):
            for slot in range(self._w_local):
                if r.gidx[slot] >= 0:
                    items.append((int(r.gidx[slot]), hid, slot))
        items.sort()
        return items

    @property
    def window_seqs(self) -> List[TRSeq]:
        return [self.ring[h].seqs[s] for _, h, s in self._window_slots()]

    def _frequent_from(self, sup: np.ndarray) -> Dict[Pattern, int]:
        out = {}
        for i in np.nonzero(self.active & (sup >= self.minsup))[0]:
            out[self.bank.patterns[i]] = int(sup[i])
        return out

    def frequent(self) -> Dict[Pattern, int]:
        """Active frequent patterns at freshly all-reduced supports
        (between refreshes supports are only all-reduced on demand;
        the refresh paths score from their already-reduced view
        instead of paying a second collective)."""
        return self._frequent_from(self._allreduce_support())

    # ----------------------------------------------------------- observe
    def observe(self, batch: Sequence[TRSeq]):
        """Slide ``batch`` into the sharded window: one routed
        containment batch (each shard owner joins its slice), then each
        arrival's merged row lands on its ring owner, which updates its
        partial supports locally - evictions decrement from the stored
        bitmap, no re-join, no cross-host traffic."""
        batch = list(batch)
        if not batch:
            return
        t0 = time.perf_counter()
        try:
            self._observe_inner(batch)
        finally:
            self._h_observe.observe(time.perf_counter() - t0)

    def _observe_inner(self, batch: List[TRSeq]) -> None:
        with trace.root_or_span("streaming.observe", n=len(batch)):
            rows = self.cluster.exact_rows(batch)
            evicted = 0
            with trace.span("streaming.ring"):
                for seq, row in zip(batch, rows):
                    hid = self._t % self.n_hosts
                    slot = (self._t // self.n_hosts) % self._w_local
                    r = self.ring[hid]
                    if r.gidx[slot] >= 0:
                        r.psum -= r.bits[slot]
                        evicted += 1
                    r.seqs[slot] = seq
                    r.bits[slot] = row
                    r.gidx[slot] = self._t
                    r.fresh[slot] = True
                    r.psum += row
                    self._t += 1
            self._any_change = True
        self.stats["arrivals"] += len(batch)
        self.stats["evictions"] += evicted
        self.stats["observe_batches"] += 1

    # ----------------------------------------------------------- refresh
    def _allreduce_support(self) -> np.ndarray:
        self.stats["allreduces"] += 1
        out = np.zeros(self.bank.n_patterns, np.int64)
        for r in self.ring:
            out += r.psum
        return out

    def _allreduce_dirty_subtrees(self) -> Set[Pattern]:
        """The per-child dirtiness all-reduce: each host reduces its
        fresh slots' bitmaps to the depth-1 subtree roots they touched
        (O(#subtrees) flags), the union is the global dirty-subtree
        set.  Coarser than per-pattern dirt but a sound superset -
        refresh_frontier only ever scans more."""
        pats = self.bank.patterns
        roots: Set[Pattern] = set()
        for r in self.ring:
            if not r.fresh.any():
                continue
            local = r.bits[r.fresh].any(axis=0)
            roots |= {depth1_root(pats[i])
                      for i in np.nonzero(local)[0]}
        return roots

    def refresh(self, full: bool = False) -> Dict[Pattern, int]:
        """The protocol's synchronisation point: all-reduce partial
        supports and the dirty-subtree flags, frontier-re-mine against
        the exact global view, extend/recompile the bank, cut
        tombstones, and broadcast the new masks/placement to every
        host.  Returns the exact frequent map (== batch re-mine)."""
        t0 = time.perf_counter()
        try:
            return self._refresh_timed(full)
        finally:
            self._h_refresh.observe(time.perf_counter() - t0)

    def _refresh_timed(self, full: bool) -> Dict[Pattern, int]:
        with trace.root_or_span("streaming.refresh", full=full):
            with trace.span("cluster.allreduce"):
                self.support = self._allreduce_support()
            self.cluster.router.support = self.support
            win = self._window_slots()
            seqs = [self.ring[h].seqs[s] for _, h, s in win]
            if full:
                return self._refresh_full(seqs, win)
            if not self._any_change:
                return self._frequent_from(self.support)
            active_rows = self.active if self.tombstones else \
                np.ones_like(self.active)
            active_map = {
                self.bank.patterns[i]: int(self.support[i])
                for i in np.nonzero(active_rows)[0]
            }
            with trace.span("cluster.allreduce"):
                droots = self._allreduce_dirty_subtrees()
            self.stats["dirty_subtrees"] += len(droots)
            dirty_mask = subtree_dirty_rows(self.bank.patterns, droots)
            dirty_set = {
                self.bank.patterns[i]
                for i in np.nonzero(dirty_mask & active_rows)[0]
            }
            with trace.span("streaming.frontier"):
                fr = refresh_frontier(
                    seqs, self.minsup, active=active_map,
                    dirty=dirty_set, any_change=True,
                    max_len=self.max_len, metrics=self.metrics,
                    **self.miner_kw,
                )
            self.stats["refreshes"] += 1
            self.stats["frontier_scans"] += fr.scans
            self.stats["frontier_scans_skipped"] += fr.scans_skipped
            self.stats["frontier_retained"] += fr.retained
            return self._reconcile(seqs, win, fr.patterns, fr.gids)

    def _reconcile(self, seqs, win, mined, gids) -> Dict[Pattern, int]:
        with trace.span("streaming.reconcile"):
            return self._reconcile_inner(seqs, win, mined, gids)

    def _reconcile_inner(self, seqs, win, mined, gids
                         ) -> Dict[Pattern, int]:
        known = {p: i for i, p in enumerate(self.bank.patterns)}
        new = {p: s for p, s in mined.items() if p not in known}
        if new and not self.bank.n_patterns:
            return self._refresh_full(seqs, win, mined=mined)
        if new:
            try:
                bank2 = extend_bank(self.bank, new)
            except BankCapacityError:
                return self._refresh_full(seqs, win, mined=mined)
            grow = bank2.n_patterns - self.bank.n_patterns
            self.support = np.concatenate(
                [self.support, np.zeros(grow, np.int64)])
            self.active = np.concatenate(
                [self.active, np.zeros(grow, bool)])
            for r in self.ring:
                r.grow(bank2.n_patterns)
            self.bank = bank2
            known = {p: i for i, p in enumerate(bank2.patterns)}
            self.stats["added"] += grow
            # new rows re-plan the placement; ring state is global-row
            # indexed, so only the serving plane rebuilds
            self._rebuild_serving()
        mined_rows = np.zeros(self.bank.n_patterns, bool)
        for p in mined:
            mined_rows[known[p]] = True
        recount = np.nonzero(mined_rows & ~self.active)[0]
        if len(recount):
            # recovered/new rows: backfill window bitmaps from the
            # miner's exact containing-gid sets, scattered back to each
            # ring owner; partial supports recompute locally
            cols = np.zeros((len(seqs), len(recount)), bool)
            for j, rr in enumerate(recount):
                cols[sorted(gids[self.bank.patterns[rr]]), j] = True
            for g, (_, hid, slot) in enumerate(win):
                self.ring[hid].bits[slot, recount] = cols[g]
            for r in self.ring:
                r.psum[recount] = r.bits[:, recount].sum(0)
            self.support[recount] = cols.sum(0)
            self.stats["recovered"] += len(recount) - len(new)
        for p, s in mined.items():
            assert int(self.support[known[p]]) == s, (
                "support drift on", p, int(self.support[known[p]]), s)
        self.active = mined_rows if self.tombstones else \
            np.ones(self.bank.n_patterns, bool)
        # cache reconciliation is the mask's job now: _apply_mask
        # patches newly-tombstoned columns per-row and clears only on
        # recoveries (ClusterRouter.apply_row_mask); cached rows do not
        # depend on supports (scoring reads router.support at query
        # time) and the bank-extension path above rebuilt the serving
        # plane - so surviving entries are exact and stay.
        self._apply_mask()
        self.cluster.router.support = self.support
        for r in self.ring:
            r.fresh[:] = False
        self._any_change = False
        return self._frequent_from(self.support)

    def _refresh_full(self, seqs, win, mined=None) -> Dict[Pattern, int]:
        """Re-mine + recompile + recount everything (escape hatch /
        tombstone compaction), then recount every ring slice through
        the fresh unmasked shard servers."""
        with trace.span("streaming.full_refresh"):
            return self._refresh_full_inner(seqs, win, mined)

    def _refresh_full_inner(self, seqs, win, mined=None
                            ) -> Dict[Pattern, int]:
        self.stats["full_refreshes"] += 1
        if mined is None:
            if seqs:
                miner = AcceleratedMiner(
                    seqs, metrics=self.metrics, **self.miner_kw)
                mined = miner.mine_rs(
                    self.minsup, max_len=self.max_len).patterns
            else:
                mined = {}
        self.bank = compile_bank(mined)
        P = self.bank.n_patterns
        self.support = np.zeros(P, np.int64)
        self.active = np.ones(P, bool)
        for r in self.ring:
            r.reset_rows(P)
            r.fresh[:] = False
        self._rebuild_serving()
        if seqs and P:
            rows = self.cluster.exact_rows(seqs)
            for g, (_, hid, slot) in enumerate(win):
                self.ring[hid].bits[slot] = rows[g]
            for r in self.ring:
                r.psum = r.bits.sum(0).astype(np.int64)
            self.support = rows.sum(0).astype(np.int64)
            self.cluster.router.support = self.support
        assert np.array_equal(
            self.support, self.bank.support[:P].astype(np.int64)
        ), "full-refresh recount disagrees with mined supports"
        self._any_change = False
        return self._frequent_from(self.support)

    # ----------------------------------------------------------- serving
    def join(self, req) -> "JoinResult":
        """Unified entry point: all-reduce the live supports into the
        router's scorer, then delegate (exactness semantics are the
        router's - shed/approx rows stay flagged ``exact=False``)."""
        self.support = self._allreduce_support()
        self.cluster.router.support = self.support
        return self.cluster.join(req)

    def query(
        self, seqs: Sequence[TRSeq], host: int = 0, k: int = 10,
    ) -> List[QueryResult]:
        """Routed containment over the active bank with top-k scored by
        live supports (all-reduced on demand)."""
        from .join import JoinRequest
        return self.join(JoinRequest(
            seqs=tuple(seqs), k=k, host=host)).results


# ---------------------------------------------------------------- replicas
class BankReplica:
    """A read replica: serves the writer's (masked) bank and applies
    shipped deltas - ``extend_bank``/``extend_trie`` appends for
    incremental refreshes, a recompile only when the writer itself
    recompiled.  Queries rank top-k by the replica's last-applied live
    supports (compile-time bank order goes stale as supports drift)."""

    def __init__(
        self,
        bank: PatternBank,
        *,
        bank_layout: str = "flat",
        trie: Optional[TrieBank] = None,
        support: Optional[np.ndarray] = None,
        active: Optional[np.ndarray] = None,
        last_seq: int = 0,
        device: DeviceLike = None,
        **server_kw,
    ):
        self.bank_layout = bank_layout
        self.device = resolve_device(device)
        self.server_kw = dict(server_kw)
        self._install(bank, trie)
        self.support = (
            bank.support[: bank.n_patterns].astype(np.int64)
            if support is None else np.asarray(support, np.int64).copy()
        )
        self.active = (
            np.ones(bank.n_patterns, bool) if active is None
            else np.asarray(active, bool).copy()
        )
        if not self.active.all():
            self.server.set_row_mask(self.active)
        self.applied = 0  # deltas applied so far
        # last applied delta sequence id: the replay cursor.  A
        # replica built from writer state at delta_seq=s starts there;
        # apply() skips any seq <= last_seq, so replaying an overlap
        # (restart catch-up) is idempotent
        self.last_seq = int(last_seq)

    def _install(self, bank: PatternBank,
                 trie: Optional[TrieBank] = None) -> None:
        self.bank = bank
        self.trie = None
        if get_layout(self.bank_layout).uses_trie:
            self.trie = trie if trie is not None else build_trie(bank)
        self.server = PatternServer(
            bank, bank_layout=self.bank_layout, trie=self.trie,
            device=self.device, **self.server_kw,
        )

    def apply(self, delta: Tuple) -> None:
        """Apply one writer delta ``(kind, seq, *payload)`` - see
        serving.streaming's delta kinds.  Deltas at or before the
        replay cursor (``seq <= last_seq``) are skipped, so replaying
        an overlapping recovery-log suffix is idempotent."""
        kind, seq = delta[0], int(delta[1])
        if seq <= self.last_seq:
            return
        if kind == "support":
            self.support = np.asarray(delta[2], np.int64)
        elif kind == "mask":
            active, support = delta[2:]
            self.active = np.asarray(active, bool)
            self.server.set_row_mask(
                None if active.all() else active)
            self.support = np.asarray(support, np.int64)
        elif kind == "extend":
            new, active, support = delta[2:]
            if new:
                bank2 = extend_bank(self.bank, new)
                trie2 = (extend_trie(self.trie, bank2)
                         if self.trie is not None else None)
                self._install(bank2, trie2)
            self.active = np.asarray(active, bool)
            self.server.set_row_mask(
                None if active.all() else active)
            self.support = np.asarray(support, np.int64)
        elif kind == "recompile":
            mined, support = delta[2:]
            self._install(compile_bank(mined))
            self.active = np.ones(self.bank.n_patterns, bool)
            self.support = np.asarray(support, np.int64)
        else:  # pragma: no cover - future delta kinds
            raise ValueError(f"unknown delta kind {kind!r}")
        self.applied += 1
        self.last_seq = seq

    def join(self, req) -> "JoinResult":
        """Unified entry point: the inner server join rescored by the
        replica's live supports (``exact`` flags pass through)."""
        from .join import JoinRequest, JoinResult
        k = 10 if req.k is None else req.k
        inner = self.server.join(JoinRequest(
            seqs=req.seqs, k=0, exact=req.exact,
            trace_id=req.trace_id))
        return JoinResult([
            dataclasses.replace(
                r, topk=score_topk(r.contained, self.support, k))
            for r in inner.results
        ])

    def query(self, seqs: Sequence[TRSeq], k: int = 10
              ) -> List[QueryResult]:
        from .join import JoinRequest
        return self.join(JoinRequest(seqs=tuple(seqs), k=k)).results


class ReplicaGroup:
    """Single-writer / read-replica topology: the writer is an ordinary
    ``StreamingBank``; every delta it emits is queued per replica and
    applied on ``sync()`` - the explicit "ship" step, so a replica
    keeps serving its previous masked bank while the writer refreshes
    (reads never block on the writer).

    **Crash / recovery** (serving.faults): every broadcast delta is
    also appended to a bounded ``RecoveryLog`` ring keyed by the
    writer's monotone delta sequence ids.  ``crash(rid)`` drops a
    replica's pending queue (a dead host loses its mailbox); a
    ``restart(rid)`` replays the log from the replica's last applied
    seq - or, when the ring already evicted that range, rebuilds the
    replica from current writer state (full state transfer) - then
    *verifies* catch-up bit-for-bit against the writer (patterns,
    supports, active mask; GTRACE-RS's reverse-search decomposition is
    what makes this cheap - all serving state is reconstructible from
    the delta stream) before the replica rejoins.  Verified recoveries
    count ``cluster.faults.recoveries`` on the writer's registry.
    Replicas serve on the writer's device unless ``device`` is given."""

    def __init__(self, writer: StreamingBank, n_replicas: int,
                 *, log_capacity: int = 256, **server_kw):
        assert n_replicas >= 1
        self.writer = writer
        self.server_kw = dict(server_kw)
        self.server_kw.setdefault("device", writer.device)
        self.pending: List[List[Tuple]] = [[] for _ in range(n_replicas)]
        self.log = RecoveryLog(log_capacity)
        self.down: Set[int] = set()
        self.faults = writer.metrics.view(
            "cluster.faults", keys=["recoveries"])
        writer.delta_sink = self._broadcast
        self.replicas = [
            self._fresh_replica() for _ in range(n_replicas)
        ]

    def _fresh_replica(self) -> BankReplica:
        """A replica built from *current* writer state - its replay
        cursor starts at the writer's current delta seq (full state
        transfer: nothing older needs replaying)."""
        w = self.writer
        return BankReplica(
            w.bank, bank_layout=w.bank_layout, trie=w.trie,
            support=w.support,
            active=w.active if w.tombstones else None,
            last_seq=w.delta_seq,
            **self.server_kw,
        )

    def _broadcast(self, delta: Tuple) -> None:
        self.log.append(int(delta[1]), delta)
        for rid, q in enumerate(self.pending):
            if rid in self.down:
                continue  # a crashed replica's mailbox is gone
            # "support" deltas are full-state: a lagging replica only
            # needs the latest one, so consecutive ones coalesce and
            # the queue stays bounded by the structural-delta rate
            if (delta[0] == "support" and q
                    and q[-1][0] == "support"):
                q[-1] = delta
            else:
                q.append(delta)

    def lag(self, rid: int) -> int:
        """Deltas shipped by the writer but not yet applied here."""
        return len(self.pending[rid])

    def sync(self, rid: Optional[int] = None) -> None:
        """Ship (apply) all pending deltas to one replica, or all live
        ones.  Syncing a crashed replica raises ``HostDownError`` -
        restart it first."""
        if rid is not None and rid in self.down:
            raise HostDownError(rid, f"replica {rid} is down")
        rids = range(len(self.replicas)) if rid is None else [rid]
        for i in rids:
            if i in self.down:
                continue
            for delta in self.pending[i]:
                self.replicas[i].apply(delta)
            self.pending[i].clear()

    # ------------------------------------------------- crash / recovery
    def crash(self, rid: int) -> None:
        """Take one replica down: queries fail (``HostDownError``) and
        shipped deltas no longer reach it - its pending queue is lost,
        exactly like a host losing its mailbox on restart.  The
        replica's *applied* state survives (a restarted process reloads
        its checkpoint); ``restart`` replays the gap."""
        self.down.add(rid)
        self.pending[rid].clear()

    def restart(self, rid: int) -> int:
        """Recover one crashed replica: replay the writer's recovery
        log from the replica's last applied seq (``None`` from the ring
        means the range was evicted - rebuild from writer state
        instead), verify catch-up bit-for-bit, then rejoin.  Returns
        the number of deltas replayed (0 for a full state transfer)."""
        rep = self.replicas[rid]
        deltas = self.log.since(rep.last_seq)
        if deltas is None:
            # the ring evicted part of the needed range: a partial
            # replay would corrupt the replica, so transfer full state
            self.replicas[rid] = self._fresh_replica()
            replayed = 0
        else:
            for delta in deltas:
                rep.apply(delta)
            replayed = len(deltas)
        self._verify(rid)
        self.down.discard(rid)
        self.faults["recoveries"] += 1
        return replayed

    def _verify(self, rid: int) -> None:
        """The rejoin gate: a recovered replica must match the writer
        bit-for-bit - same pattern set, same live supports, same
        tombstone mask.  Raises ``RuntimeError`` on any mismatch (the
        replica must NOT rejoin routing with divergent state)."""
        rep, w = self.replicas[rid], self.writer
        w_active = (w.active if w.tombstones
                    else np.ones(w.bank.n_patterns, bool))
        if rep.bank.patterns != w.bank.patterns:
            raise RuntimeError(
                f"replica {rid} failed catch-up verification: "
                "pattern set diverges from writer")
        if not np.array_equal(
                rep.support, w.support[: w.bank.n_patterns]):
            raise RuntimeError(
                f"replica {rid} failed catch-up verification: "
                "supports diverge from writer")
        if not np.array_equal(
                rep.active[: w.bank.n_patterns],
                w_active[: w.bank.n_patterns]):
            raise RuntimeError(
                f"replica {rid} failed catch-up verification: "
                "tombstone mask diverges from writer")

    def query(self, seqs: Sequence[TRSeq], replica: int = 0,
              k: int = 10) -> List[QueryResult]:
        """Serve from a replica at whatever state it has applied.
        Crashed replicas raise ``HostDownError``."""
        if replica in self.down:
            raise HostDownError(
                replica, f"replica {replica} is down")
        return self.replicas[replica].query(seqs, k=k)
