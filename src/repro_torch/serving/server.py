"""PatternServer: the request-facing layer over batched containment.

A query is a batch of incoming ``TRSeq``s; the answer, per sequence, is
which bank patterns it contains plus a support-weighted top-k.  The
server owns the production concerns around the batch.py entry points:

* request batching - misses are encoded into power-of-two (batch,
  token, pair-count) buckets, as in the JAX package, so the two
  packages see the same shapes,
* the counts prescreen - only (sequence, pattern) pairs that pass the
  sound necessary condition are joined (``pair_contains``), typically a
  small fraction of the dense grid,
* an LRU cache keyed on canonical sequence fingerprints (bank.py;
  renaming-invariant, so bijection-renamed replays of a sequence hit),
* exactness - cells flagged ``overflow & ~contained`` (the only
  undecided ones, see batch.py) are re-checked against the
  ``core.containment`` host oracle, so results always equal the oracle,
* counters (queries, cache hits, device batches, prescreened pairs,
  joined steps, fallback cells) for the ops dashboards.

Three bank layouts share all of the above (``bank_layout=``; the
strategies live in the layouts.py registry and register at the bottom
of this module):

* ``"flat"`` - one (sequence, pattern) cell per surviving prescreen
  pair, grouped by program length; each cell replays its whole program.
* ``"trie"`` - the bank compiled into a prefix trie (trie.py); the join
  advances one frontier per (sequence, trie node) level-synchronously,
  seeded from the parent node's frontier, so patterns sharing a prefix
  pay for it once.  The prescreen runs per node against the residual
  ``node_req`` rows and prunes whole subtrees at their highest failing
  ancestor.
* ``"trie_fused"`` - the same trie walked by the fused megakernel
  (kernels.trie_walk): one cell per (sequence, depth-1 subtree), the
  level iteration, frontier buffers and per-node prescreen all inside
  one kernel, so a query batch costs ONE device dispatch regardless of
  trie depth.  Escalation reuses the per-level trie replay.

Answers are identical across layouts (all are exact); the trie layouts
win on banks with real prefix sharing (see trie.py), and the fused
layout additionally removes the per-level dispatch ladder.

On the device: the server runs on ``device`` (``cuda`` unless the
caller passes ``device="cpu"``; ``kernels.resolve_device``).  The bank
tables are uploaded once at construction; a launch uploads the query
tokens and the cell lists and reads nothing back - the counts prescreen
runs on the host against host token counts (bit-identical to the
device counts: the same int32 keys), so ``launch_rows`` never waits on
the device and every device-to-host read happens in ``finalize_rows``.
On a CUDA device every predicate call launches the containment kernel
and every fused walk the trie-walk kernel; on the CPU their plain
versions run.  Rows, overflow flags and counters are bit-equal to the
JAX package's ``repro.serving.server``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.containment import contains
from ..core.graphseq import TRSeq
from ..mining.encoding import encode_db
from ..kernels import DeviceLike, resolve_device
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from .bank import PatternBank, sequence_fingerprint
from .batch import (
    fused_trie_walk,
    max_key_bucket,
    pair_contains_indexed,
    token_counts_np,
    token_index,
    trie_level_advance_gather,
    trie_root_advance,
)
from .layouts import Layout, get_layout, register_layout
from .trie import (
    REQ_MASKED,
    TrieBank,
    build_trie,
    masked_node_req,
    pack_subtrees,
)


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def prescreen_rows(
    seqs: Sequence[TRSeq], req_np: np.ndarray, n_label_keys: int
) -> np.ndarray:
    """The host-side counts prescreen as a standalone function: sound
    approximate rows ``[len(seqs), n_patterns]`` from token-key counts
    vs per-pattern requirement rows (``counts >= req``, all keys).
    True containment is always a cellwise subset; rows whose req is
    ``REQ_MASKED`` answer False.  ``PatternServer.approx_rows`` wraps
    this with the server's own req mirror; ``ClusterRouter`` calls it
    directly against its per-host req mirrors to answer a dead shard's
    rows ``exact=False`` without any host call - the bottom rung of the
    degradation ladder."""
    n_patterns = req_np.shape[0]
    out = np.zeros((len(seqs), n_patterns), bool)
    if not len(seqs) or not n_patterns:
        return out
    tdb = _encode(seqs)
    counts = token_counts_np(tdb.tokens, n_label_keys)
    out[:] = (
        counts[: len(seqs), None, :] >= req_np[None, :, :]
    ).all(-1)
    return out


def _encode(seqs: Sequence[TRSeq]):
    """Host encoding of one query batch, padded to pow-2 (token, batch)
    buckets."""
    return encode_db(
        list(seqs),
        pad_to=_pow2(max(
            1, max(sum(len(it) for it in s) for s in seqs)
        )),
        pad_seqs_to=_pow2(len(seqs)),
    )


def _bucket34(n: int) -> int:
    """Shape bucket for the fused walk's cell axis: pow-2 or
    3·2^(k-2), whichever is tighter (<= 33% padding waste vs pow-2's
    100%).  The fused walk is one launch whose cost scales with
    the padded cell count, so at small serving batches the tighter
    bucket buys back real walk time."""
    p = _pow2(n)
    q = 3 * p // 4
    return q if p >= 4 and q >= n else p


def score_topk(
    contained: np.ndarray, support: np.ndarray, k: int
) -> List[Tuple[int, int]]:
    """Support-ranked top-k of one containment row under *live*
    supports, ties broken by bank row id.  With the compile-time
    supports this equals ``PatternServer._score``'s bank-order shortcut
    (rows are ordered by (-support, canonical code)); the streaming /
    cluster layers rank with it because their supports drift from the
    compiled order.  Every layer shares this one implementation - the
    routed==single-host and replica==writer top-k bit-equality
    contracts depend on identical tie-breaking."""
    ids = np.nonzero(contained)[0]
    ranked = sorted(ids, key=lambda i: (-int(support[i]), int(i)))[:k]
    return [(int(i), int(support[i])) for i in ranked]


@dataclasses.dataclass
class QueryResult:
    fingerprint: str
    contained: np.ndarray          # [n_patterns] bool, bank order
    topk: List[Tuple[int, int]]    # (pattern id, support score)
    cached: bool = False
    # False only on the cluster's load-shed tier: ``contained`` is then
    # the prescreen overapproximation (true containment is a subset),
    # never cached, never the default (see ClusterRouter.submit)
    exact: bool = True

    @property
    def pattern_ids(self) -> np.ndarray:
        return np.nonzero(self.contained)[0]


def _fence(name: str, t0: float, device: torch.device, **args) -> None:
    """Tracing-only launch/execution split for one async device call:
    under *full* tracing, synchronize ``device`` and record both halves.
    Under sampled tracing (``trace.fencing()`` is False) record the
    dispatch half only - a fence here would serialize the async
    pipeline the sampler exists to observe.  When off this returns
    before reading any clock - the disabled path never blocks, so
    results, dispatch counts, and async overlap are untouched."""
    if not trace.enabled():
        return
    t1 = time.perf_counter()
    trace.add_complete(name, "dispatch", t0, t1 - t0, **args)
    if trace.fencing():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        trace.add_complete(name + ".device", "device", t1, t2 - t1)


@dataclasses.dataclass
class SharedEncoding:
    """Query-side device encoding shared across bank shards.

    Everything here is a function of the query batch alone:
    ``slice_bank`` preserves the global ``nv``/``n_label_keys``, so the
    tokens, the inverted token index, and the per-key counts are
    identical no matter which shard consumes them.  The cluster router
    builds one per flush and passes it to every shard's
    ``launch_rows`` - without it each shard re-encodes and re-indexes
    the same sequences (the dominant per-shard dispatch cost that made
    cluster throughput go backwards with host count).  A process-group
    host boundary would ship exactly this struct alongside the request
    batch.

    ``counts_np`` is the host mirror of ``count``, counted on the host
    from the same token keys (no device read), letting shards run the
    counts prescreen as a host compare against their ``req`` rows -
    bit-identical because both sides count the same int32 keys."""

    seqs: List[TRSeq]
    tokens: torch.Tensor           # [B, T, 6] padded query tokens
    order: torch.Tensor            # inverted token index (batch.py)
    start: torch.Tensor
    count: torch.Tensor            # [B, K] per-key token counts
    counts_np: np.ndarray          # host mirror of ``count``
    tmax: int                      # pow-2 max same-key bucket size
    n_label_keys: int


def encode_queries(
    seqs: Sequence[TRSeq], *, n_label_keys: int, device: DeviceLike = None
) -> SharedEncoding:
    """Encode one query batch into the shard-shareable device encoding
    (see ``SharedEncoding``) on ``device`` (``cuda`` unless given): one
    upload for the tokens, one index build, host counts - amortised over
    every shard instead of paid per shard."""
    device = resolve_device(device)
    seqs = list(seqs)
    assert seqs, "cannot encode an empty query batch"
    with trace.span("serving.encode", n=len(seqs), shared=True):
        tdb = _encode(seqs)
        tokens = torch.from_numpy(tdb.tokens).to(device)
        tmax = _pow2(max_key_bucket(tdb.tokens, n_label_keys))
        counts_np = token_counts_np(tdb.tokens, n_label_keys)
    t0 = time.perf_counter()
    order, start, count = token_index(
        tokens, n_label_keys=n_label_keys
    )
    _fence("serving.token_index", t0, device)
    return SharedEncoding(
        seqs=seqs, tokens=tokens, order=order, start=start,
        count=count, counts_np=counts_np, tmax=tmax,
        n_label_keys=n_label_keys,
    )


@dataclasses.dataclass
class InFlightRows:
    """One launched-but-unfenced containment batch
    (``PatternServer.launch_rows``): the dispatched join outputs stay
    on device until ``finalize_rows`` reads them, so a caller can keep
    launching batches (other shards, the next flush) while this one
    computes.  ``pending`` holds layout-specific deferred device reads;
    ``contained``/``ovf`` are the host accumulators they resolve into."""

    layout: str
    seqs: List[TRSeq]
    tokens: object
    order: object
    start: object
    count: object
    tmax: int
    contained: np.ndarray
    ovf: np.ndarray
    pending: list
    # launch timestamp (perf_counter): finalize_rows observes
    # launch-to-fence latency into the batch_seconds histogram
    t_launch: float = 0.0


class PatternServer:
    def __init__(
        self,
        bank: PatternBank,
        *,
        emax: int = 4,
        emax_retry: int = 16,
        max_batch: int = 256,
        cache_size: int = 4096,
        topk: int = 10,
        bank_layout: str = "flat",
        trie: Optional[TrieBank] = None,
        metrics: Optional[MetricsRegistry] = None,
        metrics_ns: str = "serving.server",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.bank = bank
        self.emax = emax
        self.emax_retry = emax_retry
        self.max_batch = max_batch
        self.cache_size = cache_size
        self.topk = topk
        # layout strategies live in a registry (layouts.py): the string
        # resolves to a Layout record whose hooks drive launch /
        # finalize / escalate / masking below - raises ValueError on an
        # unregistered name, like the old literal check did
        self.layout = get_layout(bank_layout)
        self.bank_layout = bank_layout
        # the (possibly masked) prescreen requirements: every launch and
        # the approx tier prescreen on host against these
        self._req_np = bank.req
        # patterns grouped by program length: the join runs exactly L_g
        # steps per group instead of the bank-wide maximum, and the
        # group's phi width shrinks to match
        self._groups = []
        n_steps = bank.n_steps[: bank.n_patterns]
        for L_g in sorted(set(int(x) for x in n_steps)):
            rows = np.nonzero(n_steps == L_g)[0].astype(np.int32)
            steps_g = self._upload(bank.steps[rows][:, :L_g])
            self._groups.append((rows, steps_g))
        # both layouts escalate undecided cells through a uniform-length
        # group replay (_resolve_undecided): map each bank row to its
        # (group, position)
        self._row_group = np.zeros(max(bank.n_patterns, 1), np.int32)
        self._row_pos = np.zeros(max(bank.n_patterns, 1), np.int32)
        for gi, (rows, _) in enumerate(self._groups):
            self._row_group[rows] = gi
            self._row_pos[rows] = np.arange(len(rows), dtype=np.int32)
        self.trie: Optional[TrieBank] = (
            trie if self.layout.uses_trie else None
        )
        self.layout.prepare(self)
        # tombstone mask (serving.streaming): inactive rows get their
        # prescreen requirements replaced by REQ_MASKED, so they are
        # never joined and always answer not-contained
        self._row_mask: Optional[np.ndarray] = None
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        # pairs_* count (sequence, pattern) prescreen pairs (flat
        # layout); cells_* count (sequence, trie node) prescreen cells
        # (trie layout) - deliberately distinct keys, the units differ.
        # Counters live in a registry (private unless ``metrics=`` is
        # passed), so a caller that rebuilds its server on a shared
        # registry keeps accumulating instead of silently zeroing.
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.stats = self.metrics.view(metrics_ns, keys=[
            "queries", "cache_hits", "device_batches",
            "pairs_possible", "pairs_prescreened",
            "cells_possible", "cells_prescreened",
            "joined_steps",
            "escalated_cells", "host_fallback_cells",
        ])
        # always-on latency percentiles (constant-memory log buckets):
        # query_seconds is the public-entry wall per exact query call,
        # batch_seconds the launch-to-fence latency per device batch
        self._h_query = self.metrics.bucket_histogram(
            f"{metrics_ns}.query_seconds")
        self._h_batch = self.metrics.bucket_histogram(
            f"{metrics_ns}.batch_seconds")

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the server's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------ layout hooks
    # Registered as the built-in layouts' strategy hooks at the bottom
    # of this module (layouts.register_layout).

    def _prepare_flat(self) -> None:
        self.trie = None  # the flat join never touches trie tables

    def _prepare_trie(self) -> None:
        bank = self.bank
        t = self.trie = (
            self.trie if self.trie is not None else build_trie(bank)
        )
        assert t.bank is bank, "trie must be built over this bank"
        self._node_req_np = t.node_req.reshape(
            t.n_nodes, bank.req.shape[1])
        # per-level host tables driving the level-synchronous scan.
        # Leaf nodes never seed children, so their cells take the
        # compaction-free path (the trie's analogue of the flat
        # join's uniform-length final step); only internal-node
        # cells pay for frontier compaction.
        has_child = np.zeros(max(t.n_nodes, 1), bool)
        has_child[t.node_parent[t.node_parent >= 0]] = True
        self._tlevels = []
        term_depth = t.node_depth[t.terminal_node[: bank.n_patterns]]
        for d, nodes in enumerate(t.levels):
            rows = np.nonzero(term_depth == d + 1)[0]
            term_pos = t.node_pos[t.terminal_node[rows]]
            leaf = ~has_child[nodes]
            term_leaf = leaf[term_pos]
            self._tlevels.append({
                "nodes": nodes,
                "leaf": leaf,
                "steps": t.node_step[nodes],
                "parent_pos": (
                    t.node_pos[t.node_parent[nodes]] if d
                    else np.zeros(len(nodes), np.int32)
                ),
                "term_rows_int": rows[~term_leaf],
                "term_pos_int": term_pos[~term_leaf],
                "term_rows_leaf": rows[term_leaf],
                "term_pos_leaf": term_pos[term_leaf],
            })

    def _prepare_trie_fused(self) -> None:
        # the per-level tables stay: escalation replays the failing
        # sub-trie level-synchronously at emax_retry (_escalate_trie),
        # shared between the trie and trie_fused layouts - so the
        # escalation/oracle semantics are bit-identical by construction
        self._prepare_trie()
        self._tpack = pack_subtrees(self.trie)
        # the packed subtree tables live on device once; per batch only
        # the surviving (sequence, subtree) cell list is uploaded
        self._pk_steps = self._upload(self._tpack.steps)
        self._pk_parent = self._upload(self._tpack.parent)
        self._pk_req = self._upload(self._tpack.pack_req(self._node_req_np))

    def _mask_flat(self) -> None:
        pass  # the flat prescreen reads _req directly

    def _mask_trie(self) -> None:
        bank = self.bank
        if self._row_mask is None:
            nreq = self.trie.node_req.reshape(
                self.trie.n_nodes, bank.req.shape[1])
        else:
            nreq = masked_node_req(self.trie, self._row_mask)
        self._node_req_np = nreq

    def _mask_trie_fused(self) -> None:
        self._mask_trie()
        # the in-kernel prescreen reads the packed per-slot req rows:
        # re-gather them from the masked node table
        self._pk_req = self._upload(self._tpack.pack_req(self._node_req_np))

    # ------------------------------------------------------------- masking
    def set_row_mask(self, active: Optional[np.ndarray]) -> None:
        """Install (or with ``None`` clear) a tombstone mask: rows where
        ``active`` is False get their prescreen requirement rows
        replaced by ``REQ_MASKED``, so the join never visits them - in
        the trie layout a subtree whose terminals are all masked is
        pruned at its highest all-masked ancestor - and their containment
        answers are always False.  Masking is prescreen-only: active
        rows keep bit-identical answers (the prescreen is sound, so
        removing candidates it would have kept cannot change survivors'
        join results).  Clears the row cache - cached rows predate the
        mask."""
        bank = self.bank
        self._cache.clear()
        if active is None:
            self._row_mask = None
            self._req_np = bank.req
            self.layout.on_mask(self)
            return
        active = np.asarray(active, bool)
        assert active.shape == (bank.n_patterns,)
        self._row_mask = active
        req = bank.req[: bank.n_patterns].copy()
        req[~active] = REQ_MASKED
        if bank.n_rows > bank.n_patterns:  # padding rows stay masked
            pad = np.full(
                (bank.n_rows - bank.n_patterns, req.shape[1]),
                REQ_MASKED, np.int32,
            )
            req = np.concatenate([req, pad])
        self._req_np = req
        self.layout.on_mask(self)

    # ------------------------------------------------------------- device
    def exact_rows(self, seqs: Sequence[TRSeq]) -> np.ndarray:
        """Exact containment rows [len(seqs), n_patterns] computed
        directly on device (chunked by ``max_batch``), bypassing the
        fingerprint cache - the streaming layer's entry point (it
        maintains per-sequence window bitmaps, so every arrival must be
        answered fresh and row-aligned).  Counts toward ``queries`` like
        ``query`` does - routed/streamed traffic is traffic.  All chunks
        launch before any is fenced, so multi-chunk calls overlap their
        device batches."""
        self.stats["queries"] += len(seqs)
        out = np.zeros((len(seqs), self.bank.n_patterns), bool)
        with trace.root_or_span("serving.exact_rows", n=len(seqs)):
            launched = []
            for start in range(0, len(seqs), self.max_batch):
                chunk = list(seqs[start : start + self.max_batch])
                launched.append((start, self._launch(chunk)))
            for start, flight in launched:
                out[start : start + len(flight.seqs)] = \
                    self.finalize_rows(flight)
        return out

    def launch_rows(
        self, seqs: Sequence[TRSeq],
        shared: Optional[SharedEncoding] = None,
    ) -> InFlightRows:
        """Dispatch the containment joins for one chunk (``<=
        max_batch``) and return without blocking: the joins stay in
        flight on device until ``finalize_rows``.  The cluster router's
        entry point - it launches one batch per shard back-to-back and
        only fences at result finalize, so shards overlap instead of
        serializing.  Pass ``shared`` (``encode_queries``) to skip this
        shard's encode/index/prescreen dispatches entirely.  Counts the
        batch toward ``queries``."""
        self.stats["queries"] += len(seqs)
        return self._launch(list(seqs), shared)

    def _launch(
        self, seqs: List[TRSeq],
        shared: Optional[SharedEncoding] = None,
    ) -> InFlightRows:
        assert len(seqs) <= self.max_batch
        layout = self.bank_layout
        t0 = time.perf_counter()
        with trace.span("serving.batch", n=len(seqs), layout=layout):
            flight = self.layout.launch(self, seqs, shared)
        flight.t_launch = t0
        return flight

    def finalize_rows(self, flight: InFlightRows) -> np.ndarray:
        """Fence one in-flight batch: read the join outputs back,
        resolve undecided cells (escalation ladder + host oracle), and
        return the exact rows.  ``launch_rows`` + ``finalize_rows`` ==
        the old synchronous batch, bit for bit."""
        with trace.span("serving.finalize_rows", n=len(flight.seqs),
                        layout=flight.layout):
            get_layout(flight.layout).finalize(self, flight)
            self._resolve_undecided(
                flight.tokens, flight.order, flight.start,
                flight.count, flight.tmax, flight.contained,
                flight.ovf, flight.seqs,
            )
            if flight.t_launch:
                self._h_batch.observe(
                    time.perf_counter() - flight.t_launch)
            return flight.contained

    def _finalize_flat(self, flight: InFlightRows) -> None:
        for b_idx, p_global, c, o, n in flight.pending:
            flight.contained[b_idx, p_global] = c[:n].cpu().numpy()
            flight.ovf[b_idx, p_global] = o[:n].cpu().numpy()

    def _finalize_trie(self, flight: InFlightRows) -> None:
        for rows, sub, acc, ovf, n in flight.pending:
            acc_np = acc[:n].cpu().numpy()
            ovf_np = ovf[:n].cpu().numpy()
            live = sub >= 0
            idx = np.clip(sub, 0, None)
            flight.contained[:, rows] = np.where(
                live, acc_np[idx], False)
            flight.ovf[:, rows] = np.where(
                live, ovf_np[idx], False)

    def _finalize_trie_fused(self, flight: InFlightRows) -> None:
        # one deferred read per batch: acc/ovft are [n_cells, n_slots],
        # terminal t of bank row rows[t] reads slot[t] of its subtree's
        # cell (sub[b, t]; -1 = the subtree never walked for b, which
        # is exactly the per-level "never seeded" False/False)
        for rows, sub, slot, acc, ovft, n in flight.pending:
            acc_np = acc[:n].cpu().numpy()
            ovf_np = ovft[:n].cpu().numpy()
            live = sub >= 0
            idx = np.clip(sub, 0, None)
            flight.contained[:, rows] = np.where(
                live, acc_np[idx, slot[None, :]], False)
            flight.ovf[:, rows] = np.where(
                live, ovf_np[idx, slot[None, :]], False)

    def _run_batch(self, seqs: List[TRSeq]) -> np.ndarray:
        """Exact containment rows [len(seqs), n_patterns] for one chunk."""
        return self.finalize_rows(self._launch(seqs))

    def _encode_own(self, seqs: List[TRSeq]):
        """Encode + index for a launch without a shared encoding (the
        single-host query path): tokens uploaded once, the inverted
        index built on the device, the prescreen counts on the host.
        Returns ``(tokens, order, start, count, tmax, counts_np)``."""
        bank = self.bank
        with trace.span("serving.encode", n=len(seqs)):
            tdb = _encode(seqs)
            tokens = self._upload(tdb.tokens)
            tmax = _pow2(max_key_bucket(tdb.tokens, bank.n_label_keys))
            counts_np = token_counts_np(tdb.tokens, bank.n_label_keys)
        t0 = time.perf_counter()
        order, start, count = token_index(
            tokens, n_label_keys=bank.n_label_keys)
        _fence("serving.token_index", t0, self.device)
        return tokens, order, start, count, tmax, counts_np

    def _encoding(self, seqs: List[TRSeq],
                  shared: Optional[SharedEncoding]):
        """``_encode_own`` or the given shared encoding, as one tuple."""
        if shared is None:
            return self._encode_own(seqs)
        assert shared.n_label_keys == self.bank.n_label_keys
        return (shared.tokens, shared.order, shared.start, shared.count,
                shared.tmax, shared.counts_np)

    def _launch_flat(
        self, seqs: List[TRSeq],
        shared: Optional[SharedEncoding] = None,
    ) -> InFlightRows:
        bank = self.bank
        # one index build per batch, shared by every group join
        tokens, order, start, count, tmax, counts_np = self._encoding(
            seqs, shared)
        # host compare against the host counts: bit-identical to the
        # device prescreen (same int32 counts, same req rows) and no
        # device read in the launch
        with trace.span("serving.prescreen_host", n=len(seqs)):
            possible = (
                counts_np[: len(seqs), None, :]
                >= self._req_np[None, : bank.n_patterns, :]
            ).all(-1)
        self.stats["device_batches"] += 1
        self.stats["pairs_possible"] += int(possible.sum())
        self.stats["pairs_prescreened"] += int(possible.size)
        contained = np.zeros((len(seqs), bank.n_patterns), bool)
        ovf_out = np.zeros_like(contained)
        pending = []
        for rows, steps_g in self._groups:
            b_idx, g_idx = np.nonzero(possible[:, rows])
            if not len(b_idx):
                continue
            if steps_g.shape[1] == 1:
                # single-TR patterns: the counts prescreen IS the exact
                # containment test (one matching-key token always embeds:
                # fresh vertices bind freely under an empty psi)
                contained[b_idx, rows[g_idx]] = True
                continue
            n = len(b_idx)
            self.stats["joined_steps"] += n * int(steps_g.shape[1])
            npad = _pow2(n)
            bi = np.zeros(npad, np.int32)
            pi = np.zeros(npad, np.int32)
            bi[:n], pi[:n] = b_idx, g_idx
            t0 = time.perf_counter()
            c, o = pair_contains_indexed(
                tokens, order, start, count, steps_g,
                self._upload(bi), self._upload(pi),
                nv=bank.nv, emax=self.emax, tmax=tmax,
                uniform_length=True,
            )
            _fence("serving.join", t0, self.device,
                   steps=int(steps_g.shape[1]), cells=n)
            pending.append((b_idx, rows[g_idx], c, o, n))
        return InFlightRows(
            layout="flat", seqs=seqs, tokens=tokens, order=order,
            start=start, count=count, tmax=tmax, contained=contained,
            ovf=ovf_out, pending=pending,
        )

    def approx_rows(self, seqs: Sequence[TRSeq]) -> np.ndarray:
        """Prescreen-only approximate rows [len(seqs), n_patterns]: the
        sound necessary condition ``counts >= req`` evaluated entirely
        on host - zero device dispatches.  True containment is always a
        subset (``contained <= approx`` cellwise); masked rows answer
        False (their req is ``REQ_MASKED``).  The cluster's load-shed
        tier serves these, flagged ``exact=False``, when the admission
        queue is over its shed depth."""
        bank = self.bank
        with trace.span("serving.approx", n=len(seqs)):
            return prescreen_rows(
                seqs, self._req_np[: bank.n_patterns], bank.n_label_keys
            )

    def _resolve_undecided(self, tokens, order, start, count, tmax,
                           contained, ovf, seqs):
        """Resolve every ``ovf & ~contained`` cell in place - the only
        undecided ones (batch.py) - first through a wider device
        frontier (trie layout: re-seed only the failing subtrees and
        replay the level-synchronous scan at ``emax_retry``, keeping
        the shared-prefix savings on the retry path; flat layout:
        uniform-length replay per program-length group), then the
        per-cell host oracle.  Both layouts end exact: this is the
        whole exactness contract."""
        if self._row_mask is not None:
            # tombstoned rows answer False, never escalate.  The flat
            # prescreen already excludes them, but a masked *terminal*
            # on a shared trie node with active descendants is still
            # joined (the node mask prunes all-masked subtrees only)
            contained[:, ~self._row_mask] = False
            ovf[:, ~self._row_mask] = False
        bank = self.bank
        if (ovf & ~contained).any():
            # an always-keep signal for the tail sampler: escalated
            # queries are the interesting ones
            trace.mark("overflow_escalated")
            if self.emax_retry > self.emax:
                self.layout.escalate(self, tokens, order, start, count,
                                     tmax, contained, ovf)
        with trace.span("serving.oracle"):
            for b, p in zip(*np.nonzero(ovf & ~contained)):
                contained[b, p] = contains(bank.patterns[p], seqs[b])
                self.stats["host_fallback_cells"] += 1

    def _escalate_flat(self, tokens, order, start, count, tmax,
                       contained, ovf):
        """Widen undecided cells through a uniform-length replay of the
        full step program, one device batch per program-length group."""
        bank = self.bank
        und_b, und_p = np.nonzero(ovf & ~contained)
        und_g = self._row_group[und_p]
        for gi, (rows, steps_g) in enumerate(self._groups):
            sel = und_g == gi
            if not sel.any():
                continue
            ub, up = und_b[sel], und_p[sel]
            m = len(ub)
            mpad = _pow2(m)
            bi = np.zeros(mpad, np.int32)
            pi = np.zeros(mpad, np.int32)
            bi[:m], pi[:m] = ub, self._row_pos[up]
            t0 = time.perf_counter()
            c2, o2 = pair_contains_indexed(
                tokens, order, start, count, steps_g,
                self._upload(bi), self._upload(pi),
                nv=bank.nv, emax=self.emax_retry, tmax=tmax,
                uniform_length=True,
            )
            _fence("serving.escalate.join", t0, self.device, cells=m)
            contained[ub, up] = c2[:m].cpu().numpy()
            ovf[ub, up] = o2[:m].cpu().numpy()
            self.stats["escalated_cells"] += m
            self.stats["joined_steps"] += m * int(steps_g.shape[1])

    def _escalate_trie(self, tokens, order, start, count, tmax,
                       contained, ovf):
        """Trie-native escalation: re-run the level-synchronous scan at
        ``emax_retry`` over only the failing sub-trie - the union of
        the undecided rows' root-to-terminal paths - so undecided
        siblings pay for their shared prefix once on the retry path too
        (the flat replay re-joins every full program separately).  No
        prescreen here: every replayed cell already passed it on the
        first pass, and a pruned path cannot host an undecided
        terminal."""
        t, bank = self.trie, self.bank
        und_b, und_p = np.nonzero(ovf & ~contained)
        B0 = contained.shape[0]
        # cells to replay: union of the undecided rows' terminal paths
        need = np.zeros((B0, max(t.n_nodes, 1)), bool)
        for b, p in zip(und_b, und_p):
            n = int(t.terminal_node[p])
            while n >= 0:
                need[b, n] = True
                n = int(t.node_parent[n])
        und_rows = np.unique(und_p)
        term_depth = t.node_depth[t.terminal_node[und_rows]]  # 1-based
        und_mask = np.zeros_like(contained)
        und_mask[und_b, und_p] = True
        F = bank.steps.shape[2]
        prev = None
        pos_prev = None
        fetch = []
        for d, lv in enumerate(self._tlevels):
            b_idx, n_idx = np.nonzero(need[:, lv["nodes"]])
            if not len(b_idx):
                break  # paths end: nothing undecided deeper
            n_cells = len(b_idx)
            self.stats["joined_steps"] += n_cells
            npad = _pow2(n_cells)
            cells = np.zeros((npad, 2 + F), np.int32)
            cells[:n_cells, 0] = b_idx
            cells[:n_cells, 2:] = lv["steps"][n_idx]
            kw = dict(emax=self.emax_retry, tmax=tmax, compact=True)
            t0 = time.perf_counter()
            if d == 0:
                out = trie_root_advance(
                    tokens, order, start, count, self._upload(cells),
                    ni=len(self._tlevels), nv=bank.nv, **kw,
                )
            else:
                par = pos_prev[b_idx, lv["parent_pos"][n_idx]]
                assert (par >= 0).all(), "escalation path parent missing"
                cells[:n_cells, 1] = par
                out = trie_level_advance_gather(
                    tokens, order, start, count, *prev,
                    self._upload(cells), **kw,
                )
            _fence("serving.escalate.trie_level", t0, self.device,
                   level=d, cells=n_cells)
            phi, psi, valid, acc, ovf_state, ovf_term = out
            prev = (phi, psi, valid, ovf_state)
            cell_pos = np.full((B0, len(lv["nodes"])), -1, np.int64)
            cell_pos[b_idx, n_idx] = np.arange(n_cells)
            pos_prev = cell_pos
            rows_d = und_rows[term_depth == d + 1]
            if len(rows_d):
                sub = cell_pos[:, t.node_pos[t.terminal_node[rows_d]]]
                fetch.append((rows_d, sub, acc, ovf_term, n_cells))
        for rows, sub, acc, ovf_t, n in fetch:
            acc_np = acc[:n].cpu().numpy()
            ovf_np = ovf_t[:n].cpu().numpy()
            # touch only the cells that were actually undecided: their
            # neighbours in these rows are already exact
            live = (sub >= 0) & und_mask[:, rows]
            idx = np.clip(sub, 0, None)
            contained[:, rows] = np.where(
                live, acc_np[idx], contained[:, rows])
            ovf[:, rows] = np.where(live, ovf_np[idx], ovf[:, rows])
            self.stats["escalated_cells"] += int(live.sum())

    def _launch_trie(
        self, seqs: List[TRSeq],
        shared: Optional[SharedEncoding] = None,
    ) -> InFlightRows:
        """Trie-layout launch: one frontier per (sequence, trie node),
        one device dispatch per trie level; a level's frontiers are
        seeded by gathering its parents' compacted frontiers from the
        previous level's cell array.  The residual-``req`` prescreen
        compacts each level to its surviving cells (a pruned node's
        subtree never seeds).  The level loop chains device frontiers
        without any host read (terminal accept bits are deferred to
        ``finalize_rows``), so the whole walk dispatches without
        blocking.  Same exactness contract as the flat path:
        overflow-undecided terminals escalate through a wider replay,
        then the host oracle."""
        bank = self.bank
        B0 = len(seqs)
        contained = np.zeros((B0, bank.n_patterns), bool)
        ovf_out = np.zeros((B0, bank.n_patterns), bool)

        def flight(tokens=None, order=None, start=None, count=None,
                   tmax=1, fetch=()):
            return InFlightRows(
                layout="trie", seqs=seqs, tokens=tokens, order=order,
                start=start, count=count, tmax=tmax,
                contained=contained, ovf=ovf_out, pending=list(fetch),
            )

        if not self._tlevels or not bank.n_patterns:
            return flight()
        tokens, order, start, count, tmax, counts_np = self._encoding(
            seqs, shared)
        with trace.span("serving.prescreen_host", n=len(seqs)):
            poss = (
                counts_np[:B0, None, :] >= self._node_req_np[None, :, :]
            ).all(-1)
        self.stats["device_batches"] += 1
        # node cells, not pattern pairs: a pattern spans several nodes,
        # so these are NOT comparable to the flat layout's pairs_* keys
        self.stats["cells_possible"] += int(poss.sum())
        self.stats["cells_prescreened"] += int(poss.size)
        D = len(self._tlevels)
        prev = None      # device frontiers of the previous level's cells
        pos_prev = None  # [B0, m_{d-1}] internal-cell index, -1 = none
        fetch = []       # deferred device->host reads (one sync at end)

        F = bank.steps.shape[2]

        def _cells(b_idx, n_idx, lv, d, compact):
            """Advance the given (sequence, node) cells one step.  One
            packed [N, 2+F] upload carries cell_b / parent idx / step
            rows."""
            n = len(b_idx)
            npad = _pow2(n)
            cells = np.zeros((npad, 2 + F), np.int32)
            cells[:n, 0] = b_idx
            cells[:n, 2:] = lv["steps"][n_idx]
            kw = dict(emax=self.emax, tmax=tmax, compact=compact)
            t0 = time.perf_counter()
            if d == 0:
                out = trie_root_advance(
                    tokens, order, start, count, self._upload(cells),
                    ni=D, nv=bank.nv, **kw,
                )
            else:
                par = pos_prev[b_idx, lv["parent_pos"][n_idx]]
                assert (par >= 0).all(), "parent cell pruned below child"
                cells[:n, 1] = par
                out = trie_level_advance_gather(
                    tokens, order, start, count, *prev,
                    self._upload(cells), **kw,
                )
            _fence("serving.trie_advance", t0, self.device,
                   level=d, cells=n)
            return out

        for d, lv in enumerate(self._tlevels):
            act = poss[:, lv["nodes"]]
            b_idx, n_idx = np.nonzero(act)
            if not len(b_idx):
                break  # prescreen is monotone: no deeper cell survives
            with trace.span("serving.trie_level", level=d,
                            cells=len(b_idx)):
                is_leaf = lv["leaf"][n_idx]
                lb, ln = b_idx[is_leaf], n_idx[is_leaf]
                ib, inn = b_idx[~is_leaf], n_idx[~is_leaf]
                # ---- leaf cells: compaction-free accept test.  Depth-1
                # leaves skip the join entirely: the node prescreen IS
                # the exact containment test for single-TR patterns (a
                # matching-key token always embeds under an empty psi).
                if len(lb):  # every leaf is some pattern's terminal
                    cell_leaf = np.full(
                        (B0, len(lv["nodes"])), -1, np.int64)
                    cell_leaf[lb, ln] = np.arange(len(lb))
                    sub = cell_leaf[:, lv["term_pos_leaf"]]
                    if d == 0:
                        contained[:, lv["term_rows_leaf"]] = sub >= 0
                    else:
                        self.stats["joined_steps"] += len(lb)
                        acc, ovf = _cells(lb, ln, lv, d, compact=False)
                        fetch.append((lv["term_rows_leaf"], sub, acc,
                                      ovf, len(lb)))
                # ---- internal cells: compacted frontiers seed children
                n_int = len(ib)
                if n_int:
                    self.stats["joined_steps"] += n_int
                    phi, psi, valid, acc, ovf_state, ovf_term = _cells(
                        ib, inn, lv, d, compact=True
                    )
                    # children inherit the full path overflow; a
                    # terminal ending at this node is undecided only via
                    # ovf_term (its accept bit is exact regardless of
                    # what this step's compaction dropped)
                    prev = (phi, psi, valid, ovf_state)
                    cell_int = np.full(
                        (B0, len(lv["nodes"])), -1, np.int64)
                    cell_int[ib, inn] = np.arange(n_int)
                    pos_prev = cell_int
                    if len(lv["term_rows_int"]):
                        sub = cell_int[:, lv["term_pos_int"]]
                        fetch.append((lv["term_rows_int"], sub, acc,
                                      ovf_term, n_int))
                else:
                    break  # no internal frontier: nothing seeds deeper
        return flight(tokens=tokens, order=order, start=start,
                      count=count, tmax=tmax, fetch=fetch)

    def _launch_trie_fused(
        self, seqs: List[TRSeq],
        shared: Optional[SharedEncoding] = None,
    ) -> InFlightRows:
        """Fused-layout launch: the whole trie walk in ONE device
        dispatch per query batch, independent of trie depth
        (kernels.trie_walk).  A cell is a (sequence, depth-1 subtree)
        pair; the kernel iterates the subtree's levels over in-kernel
        frontier buffers and applies the per-node residual-``req``
        prescreen in kernel, so only the subtree *roots* are prescreened
        host-side to pick the surviving cells.  Singleton depth-1
        subtrees are answered by the root prescreen alone (their
        terminals are single-TR patterns, for which the prescreen is
        the exact containment test - same shortcut as the per-level
        path's depth-1 leaves).  Outputs, overflow semantics and the
        escalation ladder are bit-identical to the per-level trie
        layout (the differential harness in tests/test_trie_fused.py
        pins all three layouts to the host oracle)."""
        bank = self.bank
        B0 = len(seqs)
        pack = self._tpack
        contained = np.zeros((B0, bank.n_patterns), bool)
        ovf_out = np.zeros((B0, bank.n_patterns), bool)

        def flight(tokens=None, order=None, start=None, count=None,
                   tmax=1, fetch=()):
            return InFlightRows(
                layout="trie_fused", seqs=seqs, tokens=tokens,
                order=order, start=start, count=count, tmax=tmax,
                contained=contained, ovf=ovf_out, pending=list(fetch),
            )

        if not self._tlevels or not bank.n_patterns:
            return flight()
        tokens, order, start, count, tmax, counts_np = self._encoding(
            seqs, shared)
        with trace.span("serving.prescreen_host", n=len(seqs)):
            poss = (
                counts_np[:B0, None, :] >= self._node_req_np[None, :, :]
            ).all(-1)
        self.stats["device_batches"] += 1
        # fused cells are walk *entry points* (subtree shards +
        # singleton leaves), not per-node cells: the per-node prescreen
        # runs in kernel, so only entries are prescreened host-side.  A
        # shard cell is launched only if SOME exclusive terminal of the
        # shard passes its own node prescreen - every kernel output is
        # ANDed with the terminal's ``poss`` anyway, so cells with all
        # terminals prescreen-dead contribute all-False accept/ovf bits
        # and skipping them is bit-exact (and much sharper than gating
        # at the shard root, whose ``node_req`` is the subtree min)
        leaf_poss = poss[:, pack.leaf_roots]
        shard_poss = np.zeros((B0, pack.n_subtrees), bool)
        if len(pack.term_nodes):
            np.logical_or.at(shard_poss.T, pack.term_sub,
                             poss[:, pack.term_nodes].T)
        self.stats["cells_possible"] += \
            int(shard_poss.sum()) + int(leaf_poss.sum())
        self.stats["cells_prescreened"] += \
            int(shard_poss.size) + int(leaf_poss.size)
        if len(pack.leaf_rows):
            contained[:, pack.leaf_rows] = leaf_poss
        b_idx, s_idx = np.nonzero(shard_poss)
        n = len(b_idx)
        if not n:
            return flight(tokens=tokens, order=order, start=start,
                          count=count, tmax=tmax)
        # every surviving cell walks its full padded shard in kernel
        self.stats["joined_steps"] += n * pack.n_slots
        npad = _bucket34(n)
        cells = np.zeros((npad, 2), np.int32)
        cells[:n, 0] = b_idx
        cells[:n, 1] = s_idx
        t0 = time.perf_counter()
        acc, ovft = fused_trie_walk(
            tokens, order, start, count, self._upload(cells),
            self._pk_steps, self._pk_parent, self._pk_req,
            ni=len(self._tlevels), nv=bank.nv, emax=self.emax,
            tmax=tmax,
        )
        _fence("serving.fused_walk", t0, self.device, cells=n)
        cell_of = np.full((B0, pack.n_subtrees), -1, np.int64)
        cell_of[b_idx, s_idx] = np.arange(n)
        sub = cell_of[:, pack.term_sub]
        return flight(
            tokens=tokens, order=order, start=start, count=count,
            tmax=tmax,
            fetch=[(pack.term_rows, sub, pack.term_slot, acc, ovft, n)],
        )

    # ------------------------------------------------------------ scoring
    def _score(self, contained: np.ndarray, k: int) -> List[Tuple[int, int]]:
        # bank rows are ordered by (-support, canonical code), so the
        # first k contained ids are already the support-weighted top-k
        ids = np.nonzero(contained)[0][:k]
        sup = self.bank.support
        return [(int(i), int(sup[i])) for i in ids]

    # ------------------------------------------------------------- public
    def join(self, req) -> "JoinResult":
        """The unified entry point (serving.join): exact requests run
        the cached batch pipeline, ``exact=False`` requests serve the
        prescreen-only approximate tier - sound overapproximation,
        flagged ``exact=False`` per result, never cached."""
        from .join import JoinResult, join_span
        k = self.topk if req.k is None else req.k
        seqs = list(req.seqs)
        with join_span(req, "server"):
            if req.exact:
                return JoinResult(self._query_exact(seqs, k))
            self.stats["queries"] += len(seqs)
            trace.mark("inexact")
            approx = self.approx_rows(seqs)
            return JoinResult([
                QueryResult(
                    fingerprint=sequence_fingerprint(s),
                    contained=approx[i], topk=self._score(approx[i], k),
                    cached=False, exact=False,
                )
                for i, s in enumerate(seqs)
            ])

    def query(
        self, seqs: Sequence[TRSeq], k: Optional[int] = None
    ) -> List[QueryResult]:
        from .join import JoinRequest
        return self.join(JoinRequest(seqs=tuple(seqs), k=k)).results

    def _query_exact(
        self, seqs: Sequence[TRSeq], k: int
    ) -> List[QueryResult]:
        self.stats["queries"] += len(seqs)
        t_q0 = time.perf_counter()
        try:
            return self._query_exact_inner(seqs, k)
        finally:
            self._h_query.observe(time.perf_counter() - t_q0)

    def _query_exact_inner(
        self, seqs: Sequence[TRSeq], k: int
    ) -> List[QueryResult]:
        with trace.root_or_span("serving.query", n=len(seqs)):
            rows: Dict[str, np.ndarray] = {}
            cached: Dict[str, bool] = {}
            miss_fps: List[str] = []
            miss_seqs: List[TRSeq] = []
            with trace.span("serving.cache", cat="cache"):
                fps = [sequence_fingerprint(s) for s in seqs]
                for fp, s in zip(fps, seqs):
                    if fp in rows:
                        continue
                    if fp in self._cache:
                        self._cache.move_to_end(fp)
                        rows[fp] = self._cache[fp]
                        cached[fp] = True
                        self.stats["cache_hits"] += 1
                    else:
                        # placeholder, preserves first-seen order
                        rows[fp] = None
                        cached[fp] = False
                        miss_fps.append(fp)
                        miss_seqs.append(s)
            for start in range(0, len(miss_seqs), self.max_batch):
                chunk = miss_seqs[start : start + self.max_batch]
                got = self._run_batch(chunk)
                for i, fp in enumerate(
                        miss_fps[start : start + len(chunk)]):
                    rows[fp] = got[i]
                    self._cache[fp] = got[i]
                    while len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
            with trace.span("serving.finalize"):
                return [
                    QueryResult(
                        fingerprint=fp, contained=rows[fp],
                        topk=self._score(rows[fp], k), cached=cached[fp],
                    )
                    for fp in fps
                ]

    def query_one(self, seq: TRSeq, k: Optional[int] = None) -> QueryResult:
        return self.query([seq], k)[0]


# --------------------------------------------------- layout registration
# The built-in layouts register here, at the bottom so the hooks can
# reference PatternServer's (unbound) methods; new layouts register the
# same way instead of growing if/else chains through server / router /
# cluster / streaming (see layouts.py).

def _place_flat(bank, n_hosts, trie=None):
    """Contiguous pattern-range placement."""
    return [
        np.asarray(r, np.int64)
        for r in np.array_split(
            np.arange(bank.n_patterns, dtype=np.int64), n_hosts
        )
    ]


def _place_trie(bank, n_hosts, trie=None):
    """Depth-1-subtree placement: subtrees stay intact per host, so
    every shard keeps its prefix sharing (and the fused layout its
    one-dispatch-per-shard walk)."""
    if trie is None:
        trie = build_trie(bank)
    return [np.asarray(r, np.int64) for r in trie.shard_rows(n_hosts)]


register_layout(Layout(
    name="flat", uses_trie=False,
    prepare=PatternServer._prepare_flat,
    launch=PatternServer._launch_flat,
    finalize=PatternServer._finalize_flat,
    escalate=PatternServer._escalate_flat,
    on_mask=PatternServer._mask_flat,
    place=_place_flat,
))
register_layout(Layout(
    name="trie", uses_trie=True,
    prepare=PatternServer._prepare_trie,
    launch=PatternServer._launch_trie,
    finalize=PatternServer._finalize_trie,
    escalate=PatternServer._escalate_trie,
    on_mask=PatternServer._mask_trie,
    place=_place_trie,
))
register_layout(Layout(
    name="trie_fused", uses_trie=True,
    prepare=PatternServer._prepare_trie_fused,
    launch=PatternServer._launch_trie_fused,
    finalize=PatternServer._finalize_trie_fused,
    # escalation replays the failing sub-trie level-synchronously: the
    # fused layout builds the same per-level tables, so the retry path
    # (and hence the whole exactness ladder) is shared verbatim
    escalate=PatternServer._escalate_trie,
    on_mask=PatternServer._mask_trie_fused,
    place=_place_trie,
))
