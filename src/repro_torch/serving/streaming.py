"""StreamingBank: incremental support maintenance over a sliding window.

The batch system mines a bank once and serves it; production traffic is
a *stream* - sequences arrive continuously and old ones age out of
relevance.  ``StreamingBank`` wraps a compiled ``PatternBank`` (flat or
trie layout) and keeps per-pattern supports exact under a sliding
window of the ``window`` most recent sequences, without re-mining per
update:

* ``observe(batch)`` answers each arrival with the existing device-side
  containment join (``PatternServer.exact_rows`` - prescreen, flat or
  trie-layout join, escalation, host-oracle fallback: the served bits
  are exact) and *increments* supports by the resulting row.  The row is
  also stored in a window ring buffer of per-sequence containment
  bitmaps, so when the sequence later expires its support contribution
  is *decremented* from the stored bits - eviction never re-joins
  anything.
* Patterns whose support falls below ``minsup`` are **tombstoned**: the
  server's prescreen requirement rows are masked (``REQ_MASKED``), so
  the join stops visiting them - in the trie layout a subtree whose
  terminals are all tombstoned is pruned at its highest dead ancestor.
  A tombstoned pattern's maintained support becomes a stale lower bound
  (arrivals no longer count it); it stays in the bank as a tombstone
  until a refresh recounts or a full refresh compacts it away.
* ``refresh()`` reconciles the bank with the window *incrementally*
  (``mining.incremental.refresh_frontier``): the reverse-search walk
  from the root prunes every *clean* subtree - one no arrival touched
  since the last reconcile, per the arrival containment bitmaps
  (expiries only shrink supports, which maintenance already accounts
  for, so they dirty nothing) - and re-scans only the dirty boundary,
  discovering newly frequent patterns and recovering tombstoned ones.  New patterns are appended to the bank
  (``extend_bank``) and LCP-merged into the trie (``extend_trie``)
  without recompiling existing rows; recovered/new rows get their
  window bitmaps recounted by a device join over just those rows.
  After ``refresh()`` the active frequent map is *bit-equal* to a batch
  re-mine of the window (property-tested, both layouts).
* ``refresh(full=True)`` is the exactness escape hatch and compaction
  step: re-mine the window from scratch, recompile bank + trie, recount
  all bitmaps.  It is also the automatic fallback when an incremental
  extension cannot fit the compiled capacity (``BankCapacityError``:
  e.g. a new pattern uses a label the bank's key space never saw).

Every join runs where the bank's server runs and every re-mine where
its miners run: ``device`` (``cuda`` unless given, or ``"cpu"`` for the
plain PyTorch versions of the kernels) reaches the server and every
miner the bank builds - ``from_db``'s, the frontier walk's and the full
refresh's.

With ``tombstones=False`` nothing is ever masked, so maintained
supports stay exact for *every* bank pattern continuously (not just at
refresh points) - the differential-testing mode.

Dirtiness is tracked per ring *slot*, not per pattern: a ``fresh`` flag
marks slots written since the last reconcile, and the dirty set handed
to ``refresh_frontier`` is "patterns contained in a fresh arrival still
in the window" (the stored bitmaps of the fresh slots).  Overwriting a
slot drops its dirt, so an arrival that transits the window entirely
between two reconciles dirties nothing - under heavy churn the frontier
walk prunes subtrees an accumulated per-pattern dirty scheme would have
rescanned (see mining.incremental's module docstring).

Two production follow-ons ride on top:

* ``compact_threshold`` - automatic tombstone compaction: when the
  tombstoned-row fraction crosses the threshold, the next observe or
  refresh escalates itself to ``refresh(full=True)`` (which re-mines and
  compacts the dead rows away); ``stats["auto_compactions"]`` counts the
  triggers.
* ``delta_sink`` - the single-writer/read-replica hook (see
  serving.cluster): when set, every state change a replica must mirror
  is emitted as a delta tuple - ``("support", seq, support)`` after
  each observe, ``("mask", seq, active, support)`` when tombstones
  change, ``("extend", seq, new_patterns, active, support)`` after an
  incremental reconcile, ``("recompile", seq, mined, support)`` after
  a full refresh - so replicas apply ``extend_bank``/``extend_trie``
  instead of recompiling, and keep serving the previous masked bank
  until the delta lands.  ``seq`` is a monotone sequence id (see
  ``delta_seq``): replicas track their last applied seq, skip
  duplicates idempotently, and a restarted replica replays the
  writer's ``RecoveryLog`` (serving.faults) from that point.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.graphseq import Pattern, TRSeq
from ..kernels import DeviceLike, resolve_device
from ..mining.driver import AcceleratedMiner
from ..mining.incremental import depth1_root, refresh_frontier
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from .bank import BankCapacityError, PatternBank, compile_bank, \
    extend_bank
from .layouts import get_layout
from .server import PatternServer, QueryResult, score_topk
from .trie import TrieBank, build_trie, extend_trie


@dataclasses.dataclass
class ObserveResult:
    arrived: int
    evicted: int
    tombstoned: int  # patterns newly masked by this batch
    refreshed: bool  # True when refresh_every triggered a refresh
    # [arrived, n_patterns] containment rows of the batch over the bank
    # as it was when the batch joined (masked rows read False)
    rows: np.ndarray


class StreamingBank:
    def __init__(
        self,
        bank: PatternBank,
        *,
        window: int,
        minsup: int,
        bank_layout: str = "flat",
        trie: Optional[TrieBank] = None,
        max_len: Optional[int] = None,
        tombstones: bool = True,
        refresh_every: int = 0,
        compact_threshold: Optional[float] = None,
        miner_kw: Optional[dict] = None,
        device: DeviceLike = None,
        **server_kw,
    ):
        assert window > 0 and minsup > 0
        assert compact_threshold is None or 0 < compact_threshold <= 1
        # an empty compile_bank({}) legitimately carries one padding row
        assert bank.n_rows == max(bank.n_patterns, 1), \
            "streaming requires an unpadded bank"
        self.window = window
        self.minsup = minsup
        self.max_len = max_len
        self.bank_layout = bank_layout
        self.tombstones = tombstones
        self.refresh_every = refresh_every
        self.compact_threshold = compact_threshold
        self.device = resolve_device(device)
        # every miner the bank builds runs on the server's device
        self.miner_kw = dict(miner_kw or {}, device=self.device)
        self.server_kw = dict(server_kw)
        self.bank = bank
        self.trie = trie
        P = bank.n_patterns
        self.support = np.zeros(P, np.int64)
        self.active = np.ones(P, bool)
        self._bits = np.zeros((window, P), bool)
        self._seqs: List[Optional[TRSeq]] = [None] * window
        self._head = 0   # next ring slot to write (oldest when full)
        self._count = 0
        # per-slot dirtiness: True = written since the last reconcile.
        # The slot's stored bitmap IS its dirt, so eviction self-cleans
        self._fresh = np.zeros(window, bool)
        self._any_change = False
        self._batches_since_refresh = 0
        # read-replica hook: every delta a replica must mirror is
        # pushed here (see the module docstring for the tuple kinds).
        # Deltas carry monotone sequence ids - ``(kind, seq, *payload)``
        # with ``seq == 1, 2, ...`` - so a restarted replica can replay
        # the writer's RecoveryLog from its last applied seq
        # (serving.faults) and skip duplicates idempotently.  The
        # counter advances whether or not a sink is attached: a seq is
        # a property of the stream, not of who is listening
        self.delta_sink: Optional[Callable[[Tuple], None]] = None
        self._delta_seq = 0
        # the registry outlives every server/miner rebuild: a
        # refresh(full=True) recompile re-attaches to the same counters
        # instead of zeroing them (reset is registry.reset(), only)
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.view("streaming.bank", keys=[
            "arrivals", "evictions", "observe_batches",
            "tombstoned", "recovered", "added",
            "refreshes", "full_refreshes", "auto_compactions",
            "frontier_scans", "frontier_scans_skipped",
            "frontier_retained",
            "dirty_subtrees", "clean_subtrees",
        ])
        # always-on latency percentiles: wall per observe() batch and
        # per refresh() reconcile (log-bucket histograms)
        self._h_observe = self.metrics.bucket_histogram(
            "streaming.bank.observe_seconds")
        self._h_refresh = self.metrics.bucket_histogram(
            "streaming.bank.refresh_seconds")
        self.server = self._make_server()

    # ------------------------------------------------------------ wiring
    def _make_server(self) -> PatternServer:
        with trace.span("streaming.server"):
            if get_layout(self.bank_layout).uses_trie and self.trie is None:
                self.trie = build_trie(self.bank)
            return PatternServer(
                self.bank, bank_layout=self.bank_layout, trie=self.trie,
                metrics=self.metrics, device=self.device, **self.server_kw,
            )

    def _apply_mask(self) -> None:
        if not self.tombstones:
            return
        with trace.span("streaming.mask"):
            mask = None if self.active.all() else self.active
            self.server.set_row_mask(mask)

    @classmethod
    def from_db(
        cls,
        db: Sequence[TRSeq],
        *,
        minsup: int,
        window: Optional[int] = None,
        max_len: Optional[int] = None,
        miner_kw: Optional[dict] = None,
        device: DeviceLike = None,
        **kw,
    ) -> "StreamingBank":
        """Mine ``db`` into a bank and seed the window with it (at most
        the last ``window`` sequences are retained).  The seed observe
        runs unmasked, so it leaves the bank fully reconciled: active ==
        the exact frequent set over the seeded window."""
        device = resolve_device(device)
        miner = AcceleratedMiner(db, **dict(miner_kw or {}, device=device))
        result = miner.mine_rs(minsup, max_len=max_len)
        bank = compile_bank(result)
        sb = cls(bank, window=window or max(len(db), 1), minsup=minsup,
                 max_len=max_len, miner_kw=miner_kw, device=device, **kw)
        sb.observe(db)
        # a single unmasked observe counts every bank pattern exactly
        # over the final window, so the tombstone cut it applied *is*
        # the exact frequent set: reconciled without a refresh
        sb._fresh[:] = False
        sb._any_change = False
        sb._batches_since_refresh = 0
        return sb

    # ----------------------------------------------------------- streams
    @property
    def n_patterns(self) -> int:
        return self.bank.n_patterns

    @property
    def window_seqs(self) -> List[TRSeq]:
        """Current window contents, oldest first."""
        if self._count < self.window:
            return [s for s in self._seqs[: self._count]]
        return (self._seqs[self._head:] + self._seqs[: self._head])

    def frequent(self) -> Dict[Pattern, int]:
        """The active frequent patterns with their window supports.
        Right after ``refresh()`` this is bit-equal to a batch re-mine
        of the window; between refreshes tombstoned-then-recovering
        patterns wait for the next refresh to reappear."""
        out = {}
        for i in np.nonzero(self.active & (self.support >= self.minsup))[0]:
            out[self.bank.patterns[i]] = int(self.support[i])
        return out

    def observe(self, batch: Sequence[TRSeq]) -> ObserveResult:
        """Slide ``batch`` into the window: device-join each arrival
        against the active bank (one containment row per sequence),
        increment supports, store the row in the ring, and decrement
        the expiring sequences' stored rows - no re-join on eviction.
        Tombstones are re-evaluated once per call, so the mask is fixed
        while the batch joins.  The result carries the batch's rows (the
        answers), over the bank as it was when the batch joined."""
        batch = list(batch)
        if not batch:
            return ObserveResult(0, 0, 0, False,
                                 np.zeros((0, self.bank.n_patterns), bool))
        t0 = time.perf_counter()
        try:
            return self._observe_inner(batch)
        finally:
            self._h_observe.observe(time.perf_counter() - t0)

    def _observe_inner(self, batch: List[TRSeq]) -> ObserveResult:
        with trace.root_or_span("streaming.observe", n=len(batch)):
            rows = self.server.exact_rows(batch)
            evicted = 0
            with trace.span("streaming.ring"):
                for seq, row in zip(batch, rows):
                    if self._count == self.window:
                        old = self._bits[self._head]
                        self.support -= old
                        # evictions do NOT set dirty bits: supports
                        # only decrease below an evicted-from pattern,
                        # so no new frequent descendant can appear and
                        # active descendants' supports stay
                        # maintained-exact - only arrivals can create
                        # re-scan work (incremental.py)
                        evicted += 1
                    self._seqs[self._head] = seq
                    self._bits[self._head] = row
                    self.support += row
                    # slot-granular dirt: the stored row is the dirt
                    # record, fresh marks it as arrived-since-reconcile
                    self._fresh[self._head] = True
                    self._head = (self._head + 1) % self.window
                    self._count = min(self._count + 1, self.window)
            self._any_change = True
            n_tomb = 0
            if self.tombstones:
                newly = self.active & (self.support < self.minsup)
                n_tomb = int(newly.sum())
                if n_tomb:
                    self.active &= ~newly
                    self._apply_mask()
                    self._emit("mask", self.active.copy(),
                               self.support.copy())
            self._emit("support", self.support.copy())
        self.stats["arrivals"] += len(batch)
        self.stats["evictions"] += evicted
        self.stats["observe_batches"] += 1
        self.stats["tombstoned"] += n_tomb
        self._batches_since_refresh += 1
        refreshed = False
        if self._compact_due():
            self.stats["auto_compactions"] += 1
            self.refresh(full=True)
            refreshed = True
        elif (self.refresh_every
                and self._batches_since_refresh >= self.refresh_every):
            self.refresh()
            refreshed = True
        return ObserveResult(len(batch), evicted, n_tomb, refreshed, rows)

    @property
    def delta_seq(self) -> int:
        """Sequence id of the most recently emitted delta (0 = none):
        a replica whose ``last_seq`` equals this is fully caught up."""
        return self._delta_seq

    def _emit(self, kind: str, *payload) -> None:
        self._delta_seq += 1
        if self.delta_sink is not None:
            self.delta_sink((kind, self._delta_seq) + payload)

    def _compact_due(self) -> bool:
        """Automatic tombstone compaction trigger: the tombstoned-row
        fraction crossed ``compact_threshold`` (tombstoned rows cost
        bank capacity and prescreen width until a full refresh compacts
        them away)."""
        if self.compact_threshold is None or not self.tombstones:
            return False
        P = self.bank.n_patterns
        if not P:
            return False
        return (P - int(self.active.sum())) / P >= self.compact_threshold

    # --------------------------------------------------------- dirtiness
    def dirty_rows(self) -> np.ndarray:
        """[n_patterns] bool: patterns contained in at least one fresh
        (arrived since the last reconcile) sequence *still in the
        window* - the slot-granular dirtiness index.  Eviction
        self-cleans: a transited arrival's slot was overwritten, so its
        dirt is gone."""
        if not self._fresh.any():
            return np.zeros(self.bank.n_patterns, bool)
        return self._bits[self._fresh].any(axis=0)

    def dirty_subtree_roots(self) -> Set[Pattern]:
        """The depth-1 reverse-search roots touched since the last
        reconcile - the coarse, cheaply-communicable form of the
        dirtiness index (what the sharded-window protocol all-reduces;
        see serving.cluster)."""
        return {
            depth1_root(self.bank.patterns[i])
            for i in np.nonzero(self.dirty_rows())[0]
        }

    # ----------------------------------------------------------- refresh
    def _ring_slots(self) -> List[int]:
        """Ring slots in window (oldest-first) order."""
        if self._count < self.window:
            return list(range(self._count))
        return [(self._head + i) % self.window
                for i in range(self.window)]

    def refresh(self, full: bool = False) -> Dict[Pattern, int]:
        """Reconcile the bank with the window; returns the exact
        frequent map (== batch re-mine of the window).  Incremental by
        default (frontier re-mine + bank/trie extension + recount of
        only the recovered/new rows); ``full=True`` re-mines and
        recompiles everything (the escape hatch, also compacts
        tombstones away)."""
        self._batches_since_refresh = 0
        t0 = time.perf_counter()
        try:
            with trace.root_or_span("streaming.refresh", full=full):
                return self._refresh_inner(full)
        finally:
            self._h_refresh.observe(time.perf_counter() - t0)

    def _refresh_inner(self, full: bool) -> Dict[Pattern, int]:
        seqs = self.window_seqs
        if full:
            return self._refresh_full(seqs)
        if not self._any_change:
            return self.frequent()
        with trace.span("streaming.dirty"):
            if self.tombstones:
                active_map = {
                    self.bank.patterns[i]: int(self.support[i])
                    for i in np.nonzero(self.active)[0]
                }
            else:
                # every support is exact when nothing is ever masked
                active_map = {
                    p: int(self.support[i])
                    for i, p in enumerate(self.bank.patterns)
                }
            # dirtiness only means something for rows whose supports are
            # being maintained: every row when tombstones are off, active
            # rows when on (a tombstoned row re-enters via a scan, not via
            # retention, so its dirty bit is moot)
            maintained = self.active if self.tombstones else \
                np.ones_like(self.active)
            dirty_set = {
                self.bank.patterns[i]
                for i in np.nonzero(self.dirty_rows() & maintained)[0]
            }
        with trace.span("streaming.frontier"):
            fr = refresh_frontier(
                seqs, self.minsup, active=active_map, dirty=dirty_set,
                any_change=True, max_len=self.max_len,
                metrics=self.metrics, **self.miner_kw,
            )
        self.stats["refreshes"] += 1
        self.stats["frontier_scans"] += fr.scans
        self.stats["frontier_scans_skipped"] += fr.scans_skipped
        self.stats["frontier_retained"] += fr.retained
        self.stats["dirty_subtrees"] += fr.depth1_dirty
        self.stats["clean_subtrees"] += fr.depth1_clean
        out = self._reconcile(seqs, fr.patterns, fr.gids)
        if self._compact_due():
            # the incremental reconcile left too many tombstoned rows:
            # escalate to the compacting full refresh, reusing the
            # already-exact frequent map instead of re-mining
            self.stats["auto_compactions"] += 1
            out = self._refresh_full(seqs, mined=fr.patterns)
        return out

    def _reconcile(
        self,
        seqs: List[TRSeq],
        mined: Dict[Pattern, int],
        gids: Dict[Pattern, set],
    ) -> Dict[Pattern, int]:
        with trace.span("streaming.reconcile"):
            return self._reconcile_inner(seqs, mined, gids)

    def _reconcile_inner(
        self,
        seqs: List[TRSeq],
        mined: Dict[Pattern, int],
        gids: Dict[Pattern, set],
    ) -> Dict[Pattern, int]:
        known = {p: i for i, p in enumerate(self.bank.patterns)}
        new = {p: s for p, s in mined.items() if p not in known}
        n_new = len(new)
        bank_grew = False
        if new and not self.bank.n_patterns:
            # growing out of an empty bank is a plain recompile (the
            # empty bank's padding row and 1-wide key space cannot be
            # extended in place)
            return self._refresh_full(seqs, mined=mined)
        if new:
            try:
                with trace.span("streaming.extend"):
                    grow = self._extend(new)
            except BankCapacityError:
                # a new pattern does not fit the compiled key space:
                # full recompile is the only exact option
                return self._refresh_full(seqs, mined=mined)
            bank_grew = True
            known = {p: i for i, p in enumerate(self.bank.patterns)}
            self.stats["added"] += grow
        # rows whose maintained bitmaps are stale: new rows (never
        # counted) and recovered tombstones (masked while inactive)
        mined_rows = np.zeros(self.bank.n_patterns, bool)
        for p in mined:
            mined_rows[known[p]] = True
        recount = np.nonzero(mined_rows & ~self.active)[0]
        if len(recount):
            with trace.span("streaming.recount"):
                # recovered/new rows backfill their window bitmaps from the
                # frontier miner's exact containing-gid sets - no extra
                # containment join.  gid g indexes ``seqs`` (oldest-first),
                # i.e. position g of the ring-slot order; never-written
                # slots hold all-zero bits already.
                slots = np.asarray(self._ring_slots(), np.int64)
                cols = np.zeros((len(seqs), len(recount)), bool)
                for j, r in enumerate(recount):
                    gset = gids[self.bank.patterns[r]]
                    cols[sorted(gset), j] = True
                self._bits[slots[:, None], recount[None, :]] = cols
                self.support[recount] = cols.sum(0)
                self.stats["recovered"] += len(recount) - n_new
        # maintained supports of still-active mined rows and recounted
        # supports of recovered/new rows must both equal the mined
        # (re-mine-exact) supports - the maintenance invariant
        for p, s in mined.items():
            assert int(self.support[known[p]]) == s, (
                "support drift on", p, int(self.support[known[p]]), s)
        self.active = mined_rows if self.tombstones else \
            np.ones(self.bank.n_patterns, bool)
        if bank_grew:
            # only an extended bank needs new server tables; otherwise
            # the mask refresh below is the whole serving-state change
            # (set_row_mask drops the row cache itself)
            self.server = self._make_server()
        self._apply_mask()
        self._fresh[:] = False
        self._any_change = False
        self._emit("extend", dict(new), self.active.copy(),
                   self.support.copy())
        return self.frequent()

    def _extend(self, new: Dict[Pattern, int]) -> int:
        """Append ``new`` to the bank (and the trie) and grow the per-row
        arrays with it; returns the rows added.  ``extend_bank`` raises
        ``BankCapacityError`` before anything changes."""
        bank2 = extend_bank(self.bank, new)
        grow = bank2.n_patterns - self.bank.n_patterns
        self.support = np.concatenate(
            [self.support, np.zeros(grow, np.int64)])
        self.active = np.concatenate(
            [self.active, np.zeros(grow, bool)])
        # the dirtiness index is slot-granular, nothing to grow
        self._bits = np.pad(self._bits, ((0, 0), (0, grow)))
        if self.trie is not None:
            self.trie = extend_trie(self.trie, bank2)
        self.bank = bank2
        return grow

    def _refresh_full(
        self, seqs: List[TRSeq], mined: Optional[Dict[Pattern, int]] = None
    ) -> Dict[Pattern, int]:
        """Re-mine + recompile + recount everything (escape hatch /
        tombstone compaction)."""
        with trace.span("streaming.full_refresh"):
            return self._refresh_full_inner(seqs, mined)

    def _refresh_full_inner(
        self, seqs: List[TRSeq], mined: Optional[Dict[Pattern, int]] = None
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
        self.trie = None  # rebuilt by _make_server for the trie layout
        self.server = self._make_server()
        P = self.bank.n_patterns
        self.support = np.zeros(P, np.int64)
        self.active = np.ones(P, bool)
        self._fresh[:] = False
        self._bits = np.zeros((self.window, P), bool)
        if seqs and P:
            rows = self.server.exact_rows(seqs)
            for j, slot in enumerate(self._ring_slots()):
                self._bits[slot] = rows[j]
            self.support = rows.sum(0).astype(np.int64)
        # full recount over a freshly mined bank must reproduce the
        # mined supports exactly (containment join == mining counts)
        assert np.array_equal(
            self.support, self.bank.support[:P].astype(np.int64)
        ), "full-refresh recount disagrees with mined supports"
        self._any_change = False
        self._emit("recompile", dict(mined), self.support.copy())
        return self.frequent()

    # ----------------------------------------------------------- serving
    def join(self, req) -> "JoinResult":
        """The unified entry point (serving.join): the inner server
        join (which already honours the tombstone mask on both the
        exact and approximate tiers) rescored by *live* window
        supports; ``exact`` flags pass through untouched."""
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

    def query(
        self, seqs: Sequence[TRSeq], k: int = 10
    ) -> List[QueryResult]:
        """Serve containment rows over the active bank (tombstoned rows
        answer False) with top-k scored by *live* window supports -
        compiled-time bank order goes stale as supports drift, so the
        server's order-based scoring shortcut does not apply here."""
        from .join import JoinRequest
        return self.join(JoinRequest(seqs=tuple(seqs), k=k)).results
