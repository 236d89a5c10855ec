"""Accelerated miners: host frontier + wavefront-batched device scans.

The reverse-search frontier (tiny, independent subtrees) stays on the
host; every DB scan - the >95% hot loop - is a batched device call to
the embedding-join engine.  Outputs are bit-identical to the pure-host
reference miners in ``repro.core`` (property-tested).

The wavefront scheduler
-----------------------
Reverse search makes enumeration subtrees independent, so nothing
orders the pending expansions: any set of frontier patterns can be
scanned together.  The default ``dispatch="wavefront"`` exploits that:
the work pool is drained in *slices* of many patterns at once, their
embeddings are packed into shared pow-2-bucketed device batches with a
per-row ``pattern_id`` axis (stacked ``existing`` tables and per-row
``nv``/``n_pat``/``mode`` vectors, gathered inside the kernel - see
``engine.match_signatures_batch``), and ONE dispatch covers the whole
chunk instead of one per pattern.  Signatures come back namespaced by
``pattern_id``; each chunk's valid signatures are kept as flat arrays
(``engine.signature_entries``) and the whole slice's are grouped per
(pattern, signature) once, by one stable sort (``engine.group_slice``),
so no Python set or dict is built per signature until a child is
emitted; child embeddings are rebuilt with numpy scatter/stack ops over
the whole (e,t) row set rather than a Python loop per row.
``dispatch="pattern"`` keeps the seed's one-pattern-at-a-time
traversal (same code path, slices of size one) as the benchmark
baseline; both dispatch modes return bit-equal
``MiningResult``s.  On a CUDA device every chunk is one launch of the
hand-written match_count kernel; on the CPU (``device="cpu"``) the same
call runs its plain PyTorch version.

A wavefront is just a reordered work stack, so the miner stays
checkpointable (see checkpoint.py): the pending slice items plus the
accumulated next wave serialize exactly like the seed stack, and a
resume re-enqueues them - supports are per-subtree and idempotent.

Device timing: a CUDA launch is async, so the launch and the execution
are timed separately - ``dispatch_seconds`` stops when the call
returns (input copies + launch), ``device_seconds`` after
``torch.cuda.synchronize()`` (the real device time); the result is
copied to the host after both.

Spans (``obs.trace``): a job is ``mining.prepare`` (the constructor's
DB encode and token upload) and ``mining.mine``, whose slices are
``mining.wavefront`` spans.  Inside a slice: ``mining.encode`` (the
slice's pattern encode and its blocks' concatenation, then each chunk's
padding), ``mining.upload`` (one per host-to-device copy), the measured
``mining.dispatch`` / ``mining.device`` intervals of each chunk,
``mining.aggregate`` (each chunk's signatures read back and kept as flat
arrays), ``mining.group`` (the slice's signatures grouped, once a
slice), ``mining.bound`` (the keys whose children cannot reach the
minimum support dropped, once a slice: ``engine.bound_slice``), and per
item ``mining.children`` (the surviving keys canonicalised into
children), holding a ``mining.rebuild`` per rebuilt child.

The work pool holds each pattern's embeddings as an ``EmbBlock`` (the
padded int32 ``gid`` / ``phi`` / ``psi`` rows the scans read): a child's
rows are rebuilt straight into its block, and a slice's blocks are
concatenated into the chunks, so no row becomes a Python ``Emb`` tuple
on the way.  ``Emb`` lists are taken at the public entries
(``expand_children*``, a resumed checkpoint) and encoded once there.
Counters: ``mining.emb_rows`` (rows rebuilt into blocks),
``mining.emb_decoded`` (rows decoded back into ``Emb`` tuples: only a
checkpoint's save does that), ``mining.sig_rows`` (valid signature
entries grouped), ``mining.sig_keys`` (distinct (pattern, signature)
keys they group into) and ``mining.sig_keys_bounded`` (the keys of
those that ``mining.bound`` drops).
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple,
                    Union)

import numpy as np
import torch

from ..core.canonical import canonical_form, canonical_map
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from ..core.enumerate_host import Emb, apply_extension
from ..core.gtrace import MiningResult
from ..core.graphseq import Pattern, TRSeq, pattern_length, pattern_vertices
from ..core.reverse_search import parent
from ..kernels import DeviceLike, resolve_device
from .encoding import (
    PAD_PHI,
    PAD_PSI,
    EmbBlock,
    TokenDB,
    encode_db,
    encode_pattern_trs,
    signature_to_extkey,
)
from .engine import (
    MODE_EDGE_PHASE,
    MODE_ROOT,
    MODE_TAIL,
    MODE_VERTEX_PHASE,
    SliceGroups,
    bound_slice,
    group_slice,
    match_signatures_batch,
    signature_entries,
)

MAX_PATTERN_TRS = 64

# a child as the expansions return it: (pattern, gids, its embeddings)
Child = Tuple[Pattern, Set[int], EmbBlock]


def _pow2_pad(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= n (clamped to cap when given, but never
    below n) - bounds the set of chunk shapes."""
    p = 1 << max(0, math.ceil(math.log2(max(n, 1))))
    if cap is not None:
        p = min(p, cap)
    return max(p, n)


class AcceleratedMiner:
    def __init__(
        self,
        db: Sequence[TRSeq],
        max_itemsets: int = 16,
        max_vertices: int = 12,
        e_batch: int = 1024,
        dispatch: str = "wavefront",
        wave_patterns: int = 256,
        wave_rows: Optional[int] = None,
        metrics: Optional[MetricsRegistry] = None,
        metrics_ns: str = "mining",
        device: DeviceLike = None,
    ):
        """``device`` is where the scans run: ``cuda`` when not given
        (raising when CUDA is absent), or ``"cpu"`` for the plain
        PyTorch version."""
        assert dispatch in ("wavefront", "pattern"), dispatch
        self.device = resolve_device(device)
        self.db = db
        self.ni = max_itemsets
        self.nv = max_vertices
        self.e_batch = e_batch
        self.dispatch = dispatch
        # wavefront slice bounds: at most this many patterns / embedding
        # rows per batched expansion (the checkpoint granularity; pow-2
        # padding of the pattern axis bounds the set of chunk shapes)
        self.wave_patterns = wave_patterns
        self.wave_rows = 4 * e_batch if wave_rows is None else wave_rows
        with trace.root_or_span("mining.prepare"):
            self.tdb: TokenDB = encode_db(db)
            # the device copy, made once; the host keeps self.tdb.tokens
            # for the embedding rebuild
            self.tokens = self._to_device(self.tdb.tokens)
        # counters live in a registry (private by default; pass
        # ``metrics=`` to accumulate across miner rebuilds, e.g. the
        # streaming bank's incremental refreshes)
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._c_device_s = self.metrics.counter(
            f"{metrics_ns}.device_seconds")
        self._c_dispatch_s = self.metrics.counter(
            f"{metrics_ns}.dispatch_seconds")
        self._c_calls = self.metrics.counter(
            f"{metrics_ns}.n_device_calls")
        self._h_wave = self.metrics.histogram(
            f"{metrics_ns}.wave_patterns")
        self._c_emb_rows = self.metrics.counter(f"{metrics_ns}.emb_rows")
        self._c_emb_decoded = self.metrics.counter(
            f"{metrics_ns}.emb_decoded")
        self._c_sig_rows = self.metrics.counter(f"{metrics_ns}.sig_rows")
        self._c_sig_keys = self.metrics.counter(f"{metrics_ns}.sig_keys")
        self._c_sig_keys_bounded = self.metrics.counter(
            f"{metrics_ns}.sig_keys_bounded")
        # what a child pruned by ``want_embs`` comes back with
        self._no_embs = EmbBlock.from_embs([], self.ni, self.nv)

    # registry-backed views of the historical timing attributes
    @property
    def device_seconds(self) -> float:
        """Launch + execution (blocked)."""
        return self._c_device_s.value

    @property
    def dispatch_seconds(self) -> float:
        """Async launch only."""
        return self._c_dispatch_s.value

    @property
    def n_device_calls(self) -> int:
        return self._c_calls.value

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """One host-to-device copy: one ``mining.upload`` span."""
        with trace.span("mining.upload", "dispatch"):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- phases
    @staticmethod
    def _phase_mode(pattern: Pattern, rs: bool) -> int:
        if not rs:
            return MODE_TAIL
        if not pattern:
            return MODE_ROOT
        if any(tr.is_vertex for s in pattern for tr in s):
            return MODE_VERTEX_PHASE
        return MODE_EDGE_PHASE

    # ------------------------------------------------------------- scans
    def _scan_batch(
        self, items: List[Tuple[Pattern, EmbBlock]], modes: List[int]
    ) -> SliceGroups:
        """Run the device scans for a wavefront slice: all items' rows
        are packed into shared pow-2 chunks (a chunk freely spans
        pattern boundaries) and each chunk is ONE device dispatch.
        Returns the slice's signatures grouped per (item, signature),
        with ``e`` local to the item's embedding block."""
        n = len(items)
        with trace.span("mining.encode"):
            n_pad = _pow2_pad(n)
            nv_stack = np.zeros(n_pad, np.int32)
            npat_stack = np.zeros(n_pad, np.int32)
            mode_stack = np.zeros(n_pad, np.int32)
            ex_stack = np.full((n_pad, MAX_PATTERN_TRS, 5), -9, np.int32)
            for i, (pattern, _) in enumerate(items):
                nv_stack[i] = len(pattern_vertices(pattern))
                npat_stack[i] = len(pattern)
                mode_stack[i] = modes[i]
                ex_stack[i] = encode_pattern_trs(pattern, MAX_PATTERN_TRS)
            lens = np.asarray([len(b) for _, b in items], np.int64)
            offs = np.cumsum(lens) - lens
            R = int(lens.sum())
            if R:
                gid_all = np.concatenate([b.gid for _, b in items])
                phi_all = np.concatenate([b.phi for _, b in items])
                psi_all = np.concatenate([b.psi for _, b in items])
                pid_all = np.repeat(np.arange(n, dtype=np.int32), lens)
        ex_j = self._to_device(ex_stack)
        nv_j = self._to_device(nv_stack)
        npat_j = self._to_device(npat_stack)
        mode_j = self._to_device(mode_stack)
        chunks = []
        for start in range(0, R, self.e_batch):
            E = min(self.e_batch, R - start)
            with trace.span("mining.encode"):
                Epad = _pow2_pad(E, cap=self.e_batch)
                sl = slice(start, start + E)
                gid = gid_all[sl]
                phi = phi_all[sl]
                psi = psi_all[sl]
                pid = pid_all[sl]
                if Epad > E:
                    gid = np.pad(gid, (0, Epad - E))
                    phi = np.pad(phi, ((0, Epad - E), (0, 0)),
                                 constant_values=PAD_PHI)
                    psi = np.pad(psi, ((0, Epad - E), (0, 0)),
                                 constant_values=PAD_PSI)
                    pid = np.pad(pid, (0, Epad - E))
                valid = np.zeros((Epad,), np.int32)
                valid[:E] = 1
            t0 = time.perf_counter()
            sigs = match_signatures_batch(
                self.tokens,
                self._to_device(gid), self._to_device(phi),
                self._to_device(psi), self._to_device(valid),
                self._to_device(pid),
                ex_j, nv_j, npat_j, mode_j,
            )
            t1 = time.perf_counter()
            self._c_dispatch_s.inc(t1 - t0)
            if self.device.type == "cuda":
                # async launch: launch != done
                torch.cuda.synchronize(self.device)
            t2 = time.perf_counter()
            self._c_device_s.inc(t2 - t0)
            self._c_calls.inc()
            # intervals are measured above regardless of tracing, so
            # recording them cannot perturb the timing they describe
            trace.add_complete("mining.dispatch", "dispatch",
                               t0, t1 - t0, rows=int(Epad))
            trace.add_complete("mining.device", "device", t1, t2 - t1)
            with trace.span("mining.aggregate"):
                keys, e, t, g = signature_entries(sigs.cpu().numpy(), gid, pid)
                chunks.append((keys, e + start, t, g))
        with trace.span("mining.group"):
            groups = group_slice(chunks, offs)
            self._c_sig_rows.inc(len(groups.e))
            self._c_sig_keys.inc(len(groups.sig))
        return groups

    # -------------------------------------------------- embedding rebuild
    def _rebuild_embeddings(
        self,
        pattern: Pattern,
        block: EmbBlock,
        sig: int,
        e_i: np.ndarray,
        t_i: np.ndarray,
        child_raw: Pattern,
    ) -> EmbBlock:
        """Vectorized child-embedding rebuild: phi insertion, the psi
        variant construction, canonical remap, first-seen dedup and the
        padded block are numpy column ops over the whole (e,t) row set
        (the extension key - and therefore the variant case - is
        constant per signature, so no Python runs per row)."""
        (slot_kind, slot_idx), ptr = signature_to_extkey(sig)
        nv = len(pattern_vertices(pattern))
        n_pat = len(pattern)
        vmap = canonical_map(child_raw)
        gid_all, phi_all, psi_all = block.gid, block.phi, block.psi
        gids_r = gid_all[e_i].astype(np.int64)
        tok = self.tdb.tokens[gids_r, t_i]
        u1, u2, j = tok[:, 1], tok[:, 2], tok[:, 4]
        phi_r = phi_all[e_i]
        if slot_kind == "in":
            new_phi = phi_r[:, :n_pat]
        else:
            new_phi = np.concatenate(
                [phi_r[:, :slot_idx], j[:, None],
                 phi_r[:, slot_idx:n_pat]], axis=1)
        psi_r = psi_all[e_i][:, :nv]
        if ptr.is_vertex:
            if ptr.u1 == nv:  # fresh vertex
                psis = [np.concatenate([psi_r, u1[:, None]], axis=1)]
            else:
                psis = [psi_r]
        elif ptr.u2 == nv + 1:  # both endpoints fresh: two bindings
            psis = [
                np.concatenate([psi_r, u1[:, None], u2[:, None]], axis=1),
                np.concatenate([psi_r, u2[:, None], u1[:, None]], axis=1),
            ]
        elif ptr.u2 == nv:  # one fresh endpoint
            mapped_dv = psi_r[:, ptr.u1]
            fresh_dv = np.where(mapped_dv == u1, u2, u1)
            psis = [np.concatenate([psi_r, fresh_dv[:, None]], axis=1)]
        else:
            psis = [psi_r]
        nv_child = psis[0].shape[1]
        perm = np.asarray([vmap[pv] for pv in range(nv_child)])
        n_phi = new_phi.shape[1]
        variants = []
        for ps in psis:
            canon = np.empty_like(ps)
            canon[:, perm] = ps  # scatter into canonical vertex order
            variants.append(np.concatenate(
                [gids_r[:, None], new_phi, canon], axis=1))
        if len(variants) == 2:  # interleave bindings per row
            rows = np.stack(variants, axis=1).reshape(
                2 * len(e_i), 1 + n_phi + nv_child)
        else:
            rows = variants[0]
        _, first = np.unique(rows, axis=0, return_index=True)
        rows = rows[np.sort(first)]  # dedup, first-seen order
        E = len(rows)
        self._c_emb_rows.inc(E)
        phi = np.full((E, self.ni), PAD_PHI, np.int32)
        phi[:, :n_phi] = rows[:, 1:1 + n_phi]
        psi = np.full((E, self.nv), PAD_PSI, np.int32)
        psi[:, :nv_child] = rows[:, 1 + n_phi:]
        return EmbBlock(rows[:, 0].astype(np.int32), phi, psi)

    # -------------------------------------------------- child expansion
    def _children_from_groups(
        self,
        pattern: Pattern,
        block: EmbBlock,
        groups: SliceGroups,
        keep: np.ndarray,
        item: int,
        min_support: int,
        rs: bool,
        want_embs: Optional[Callable[[Pattern], bool]],
    ) -> List[Child]:
        """Item ``item``'s children from the slice's grouped signatures
        that ``keep`` keeps: a child's gids are the union of its
        signatures' gid slices, its rows those of its first signature."""
        lo, hi = int(groups.items[item]), int(groups.items[item + 1])
        ks = np.flatnonzero(keep[lo:hi]) + lo
        by_child: Dict[Pattern, Tuple[Pattern, List[int]]] = {}
        for k, sig in zip(ks.tolist(), groups.sig[ks].tolist()):
            key = signature_to_extkey(sig)
            if max(key[1].u1, key[1].u2) >= self.nv:
                continue  # vertex-capacity guard
            child_raw = apply_extension(pattern, key)
            child = canonical_form(child_raw)
            if child in by_child:
                by_child[child][1].append(k)
            else:
                by_child[child] = (child_raw, [k])
        out: List[Child] = []
        gid_lo, gid_hi, all_gids = groups.gid_lo, groups.gid_hi, groups.gids
        for child, (child_raw, ks) in by_child.items():
            gids = (all_gids[gid_lo[ks[0]]:gid_hi[ks[0]]] if len(ks) == 1
                    else np.unique(np.concatenate(
                        [all_gids[gid_lo[k]:gid_hi[k]] for k in ks])))
            if len(gids) < min_support:
                continue
            if rs and parent(child) != pattern:
                continue  # reverse-search membership test
            gset = set(gids.tolist())
            if want_embs is not None and not want_embs(child):
                out.append((child, gset, self._no_embs))
                continue
            k = ks[0]
            rows = slice(groups.row_lo[k], groups.row_hi[k])
            with trace.span("mining.rebuild"):
                child_embs = self._rebuild_embeddings(
                    pattern, block, int(groups.sig[k]), groups.e[rows],
                    groups.t[rows], child_raw
                )
            out.append((child, gset, child_embs))
        return out

    def expand_children_batch(
        self,
        items: Sequence[Tuple[Pattern, Union[EmbBlock, List[Emb]]]],
        min_support: int,
        *,
        rs: bool = True,
        want_embs: Optional[Callable[[Pattern], bool]] = None,
    ) -> List[List[Child]]:
        """One batched expansion of a whole wavefront slice: every
        item's DB scan shares the packed device chunks (see
        ``_scan_batch``); the result is per-item, aligned with
        ``items``, each entry exactly what ``expand_children`` would
        have returned for that item alone.  An item's embeddings are an
        ``EmbBlock`` or a list of ``Emb`` tuples (encoded once here);
        children come back with ``EmbBlock``s.  Items at the itemset
        capacity come back empty (same guard as the single-item path)."""
        out: List[List[Child]] = [[] for _ in items]
        live = [
            (i, p, self._as_block(e)) for i, (p, e) in enumerate(items)
            if len(p) < self.ni
        ]
        if not live:
            return out
        modes = [self._phase_mode(p, rs) for _, p, _ in live]
        groups = self._scan_batch([(p, b) for _, p, b in live], modes)
        with trace.span("mining.bound"):
            keep = bound_slice(
                groups, [len(pattern_vertices(p)) for _, p, _ in live],
                min_support)
            self._c_sig_keys_bounded.inc(len(keep) - int(keep.sum()))
        for item, (i, p, b) in enumerate(live):
            with trace.span("mining.children"):
                out[i] = self._children_from_groups(
                    p, b, groups, keep, item, min_support, rs, want_embs
                )
        return out

    def _as_block(self, embs: Union[EmbBlock, List[Emb]]) -> EmbBlock:
        if isinstance(embs, EmbBlock):
            return embs
        return EmbBlock.from_embs(embs, self.ni, self.nv)

    def expand_children(
        self,
        pattern: Pattern,
        embs: Union[EmbBlock, List[Emb]],
        min_support: int,
        *,
        rs: bool = True,
        want_embs: Optional[Callable[[Pattern], bool]] = None,
    ) -> List[Child]:
        """One reverse-search (or baseline tail-growth) expansion: scan
        the DB for one-TR extensions of ``pattern`` and return its
        frequent children as ``(child, gids, child_embs)``, the child's
        embeddings as an ``EmbBlock`` (``embs`` is a block or a list of
        ``Emb`` tuples, the root's ``[(g, (), ()) ...]``).  ``gids`` is
        the exact set of DB sequences containing the child (supports are
        ``len(gids)``; the streaming layer turns these into window
        containment bitmaps without a separate join).

        With ``rs=True`` children are filtered by the spanning-tree
        membership test (``parent(child) == pattern``) exactly as the
        full miner does, so iterating this from the root reproduces
        ``mine_rs`` - and iterating it from a *frontier* of known
        patterns is the incremental re-mine (mining.incremental; batch
        the frontier through ``expand_children_batch`` to share device
        chunks across patterns).  ``want_embs(child)`` lets callers skip
        the embedding rebuild for children whose subtree they will not
        descend into (the clean-subtree prune); such children come back
        with an empty block.  Respects the miner's itemset/vertex capacity
        guards."""
        return self.expand_children_batch(
            [(pattern, embs)], min_support, rs=rs, want_embs=want_embs
        )[0]

    # ------------------------------------------------------------ mining
    def _take_slice(
        self,
        pending: "deque[Tuple[Pattern, EmbBlock]]",
        max_len: Optional[int],
        wavefront: bool,
    ) -> List[Tuple[Pattern, EmbBlock]]:
        """Pop the next expansion slice off the work pool, applying the
        length/capacity guards exactly as the seed stack loop did.
        Wavefront mode drains FIFO up to the slice bounds (many
        patterns, one batched call); pattern mode pops LIFO one at a
        time (the seed's per-pattern dispatch, kept as the benchmark
        baseline)."""
        items: List[Tuple[Pattern, EmbBlock]] = []
        rows = 0
        while pending:
            pattern, embs = (
                pending.popleft() if wavefront else pending.pop()
            )
            if max_len is not None and pattern_length(pattern) >= max_len:
                continue
            if len(pattern) >= self.ni:
                continue  # capacity guard (configurable)
            items.append((pattern, embs))
            rows += len(embs)
            if (
                not wavefront
                or len(items) >= self.wave_patterns
                or rows >= self.wave_rows
            ):
                break
        return items

    def _mine(
        self,
        min_support: int,
        max_len: Optional[int],
        rs: bool,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,
        resume: bool = False,
    ) -> MiningResult:
        from .checkpoint import load_state, save_state

        res = MiningResult()
        root = ((), EmbBlock.root(len(self.db), self.ni, self.nv))
        pending: "deque[Tuple[Pattern, EmbBlock]]" = deque([root])
        if resume and checkpoint_path:
            patterns, stack, meta = load_state(checkpoint_path)
            res.patterns.update(patterns)
            res.n_enumerated = meta.get("n_enumerated", len(patterns))
            pending = deque((p, self._as_block(e)) for p, e in stack)
        # canonical dedup is baseline-only (rs children are unique by
        # the membership test); skip their embedding rebuilds too
        want = (
            None if rs else (lambda child: child not in res.patterns)
        )
        wavefront = self.dispatch == "wavefront"
        expansions_since_ckpt = 0
        with trace.root_or_span("mining.mine", rs=rs,
                                min_support=min_support):
            while pending:
                items = self._take_slice(pending, max_len, wavefront)
                if not items:
                    break  # guards drained the pool
                res.n_extension_scans += len(items)
                self._h_wave.observe(len(items))
                with trace.span("mining.wavefront",
                                patterns=len(items)):
                    for kids in self.expand_children_batch(
                        items, min_support, rs=rs, want_embs=want
                    ):
                        for child, gids, child_embs in kids:
                            if not rs and child in res.patterns:
                                continue
                            res.patterns[child] = len(gids)
                            res.n_enumerated += 1
                            pending.append((child, child_embs))
                expansions_since_ckpt += len(items)
                if (
                    checkpoint_path
                    and expansions_since_ckpt >= checkpoint_every
                ):
                    with trace.span("mining.checkpoint"):
                        # the wire holds Emb tuples: every row is decoded
                        self._c_emb_decoded.inc(
                            sum(len(b) for _, b in pending))
                        save_state(
                            checkpoint_path, res.patterns,
                            list(pending),
                            meta={"min_support": min_support, "rs": rs,
                                  "n_enumerated": res.n_enumerated},
                        )
                    expansions_since_ckpt = 0
        if checkpoint_path:
            save_state(
                checkpoint_path, res.patterns, [],
                meta={"min_support": min_support, "rs": rs,
                      "n_enumerated": res.n_enumerated, "done": True},
            )
        return res

    def mine_rs(self, min_support: int, max_len: int | None = None,
                **kw) -> MiningResult:
        """GTRACE-RS with device-side extension scans."""
        return self._mine(min_support, max_len, rs=True, **kw)

    def mine_gtrace(self, min_support: int, max_len: int | None = None,
                    **kw) -> MiningResult:
        """Original-GTRACE baseline with device-side extension scans."""
        return self._mine(min_support, max_len, rs=False, **kw)
