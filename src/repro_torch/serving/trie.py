"""Prefix-trie pattern bank: shared-frontier serving over rFTS prefixes.

GTRACE-RS enumerates rFTSs as nodes of a reverse-search spanning tree
(Defs 8-10), so mined banks are heavily prefix-shared: sibling patterns
extend a common ancestor, and their step programs (bank.py) agree on
their leading rows.  The flat ``PatternBank`` replays those shared
prefixes once per pattern per sequence; the trie bank stores each
distinct prefix once - a node table of (step row, parent id) where the
root-to-node path is the shared prefix of every pattern below it, and a
pattern terminates at the node ending its program - so the embedding
join (batch.py) advances one frontier per (sequence, trie node) and
sibling patterns pay for their common prefix exactly once.

Construction is longest-common-prefix merging: programs are inserted
row by row into the trie, so any two patterns share nodes for exactly
their longest common program prefix.  The reverse-search ``parent()``
chain motivates the layout but cannot drive it literally: ``parent(p)``
re-canonicalizes after removing a TR (Def 7), so the parent's *program*
is a literal prefix of the child's only when the canonical relabeling
happens to survive the removal (``parent_prefix_hits`` counts these;
typically a minority).  LCP merging subsumes the parent chain - every
literal parent prefix is a trie path by construction - and also merges
prefixes the spanning tree does not relate, so it is used for every
input (``MiningResult`` or raw ``Mapping[Pattern, int]``); the chain is
only consulted for the stats.

Residual-``req`` prescreen: each node carries
``node_req[n] = min over terminals t below n of bank.req[t]``
(elementwise over token keys).  ``counts_b >= node_req[n]`` is a sound
necessary condition for *any* pattern below ``n`` to be contained in
sequence ``b`` (every such pattern needs at least ``req[t] >=
node_req[n]`` tokens per key), and it is monotone up the trie
(``node_req[parent] <= node_req[child]`` since the parent's subtree is
a superset), so a failing node fails its whole subtree and the scan
prunes it at its highest failing ancestor - no descendant cell is ever
seeded.

Flat vs trie: the trie join wins when patterns share prefixes (deep
banks mined with reverse search; the win grows with bank size since
sibling counts grow) and costs one device dispatch per trie *level*
instead of one per program-length group.  Prefer the flat layout for
tiny banks, banks of unrelated patterns (sharing ratio ~1), or
single-level banks where the flat server's prescreen-is-containment
shortcut for 1-TR patterns already answers without joining.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np

from ..core.gtrace import MiningResult
from ..kernels import REQ_MASKED
from .bank import (
    STEP_FIELDS,
    PatternBank,
    compile_bank,
    pattern_steps,
    slice_bank,
)


@dataclasses.dataclass
class TrieLevels:
    """Level-padded dense view of a trie (the device join's layout).

    Every level is padded to a common width ``Mh``; padding nodes have
    ``step_valid=0`` rows (never match) and parent position 0.  A
    pattern row ``p`` terminates at position ``term_pos[p]`` of level
    ``term_level[p]`` (0/0 for bank padding rows - masked by
    ``pattern_valid``)."""

    steps: np.ndarray       # [D, Mh, STEP_FIELDS] int32
    parent_pos: np.ndarray  # [D, Mh] int32, position within level d-1
    term_level: np.ndarray  # [n_rows] int32
    term_pos: np.ndarray    # [n_rows] int32

    @property
    def depth(self) -> int:
        return self.steps.shape[0]

    @property
    def width(self) -> int:
        return self.steps.shape[1]


@dataclasses.dataclass
class TrieBank:
    """A ``PatternBank`` re-laid-out as a prefix trie of step rows."""

    node_step: np.ndarray      # [M, STEP_FIELDS] int32
    node_parent: np.ndarray    # [M] int32 (-1 = child of the root)
    node_depth: np.ndarray     # [M] int32 (1-based; root is implicit)
    node_req: np.ndarray       # [M, 6*n_label_keys] residual prescreen
    terminal_node: np.ndarray  # [n_rows] int32 node per bank row (-1 pad)
    bank: PatternBank          # the flat bank (same pattern row order)
    # nodes per depth, ids ascending (ids are assigned in program order,
    # so a parent's id is always smaller than its children's)
    levels: List[np.ndarray] = dataclasses.field(default_factory=list)
    node_pos: np.ndarray = None  # [M] position of each node in its level
    parent_prefix_hits: int = -1  # reverse-search stats, -1 = unknown

    @property
    def n_nodes(self) -> int:
        return self.node_step.shape[0]

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def sharing_ratio(self) -> float:
        """Flat joined-steps over trie nodes (>= 1; higher = more shared
        prefix work deduplicated)."""
        total = int(self.bank.n_steps[: self.bank.n_patterns].sum())
        return total / max(self.n_nodes, 1)

    # ------------------------------------------------------------ views
    def padded_levels(
        self, depth: int | None = None, width: int | None = None
    ) -> TrieLevels:
        """Dense [D, Mh] view for the level-synchronous device join;
        ``depth``/``width`` round up for cross-shard uniformity."""
        D = max(self.depth, 1 if depth is None else 0)
        if depth is not None:
            assert depth >= self.depth, (depth, self.depth)
            D = depth
        Mh = max((len(lv) for lv in self.levels), default=1)
        if width is not None:
            assert width >= Mh, (width, Mh)
            Mh = width
        steps = np.zeros((D, Mh, STEP_FIELDS), np.int32)
        parent_pos = np.zeros((D, Mh), np.int32)
        for d, nodes in enumerate(self.levels):
            steps[d, : len(nodes)] = self.node_step[nodes]
            if d > 0:
                parent_pos[d, : len(nodes)] = self.node_pos[
                    self.node_parent[nodes]
                ]
        n_rows = self.bank.n_rows
        term_level = np.zeros(n_rows, np.int32)
        term_pos = np.zeros(n_rows, np.int32)
        real = self.terminal_node[: self.bank.n_patterns]
        term_level[: len(real)] = self.node_depth[real] - 1
        term_pos[: len(real)] = self.node_pos[real]
        return TrieLevels(steps=steps, parent_pos=parent_pos,
                          term_level=term_level, term_pos=term_pos)

    # ------------------------------------------------------------ shard
    def shard_rows(self, n_shards: int) -> List[List[int]]:
        """The bank-row assignment behind ``shard``: rows grouped by
        depth-1 subtree, subtrees packed onto shards by greedy
        node-count balancing (a subtree's weight is the join work it
        seeds), rows sorted within each shard to keep bank
        (support-desc) order.  Shards may be empty when the root has
        fewer children than ``n_shards``.  The cluster layer
        (serving.cluster) uses this as its bank placement - a subtree is
        never split across hosts, so every host joins intact
        sub-tries."""
        bank = self.bank
        # depth-1 ancestor of each pattern row
        anc = np.asarray(self.terminal_node[: bank.n_patterns])
        anc = anc.copy()
        for i, node in enumerate(anc):
            n = int(node)
            while self.node_parent[n] >= 0:
                n = int(self.node_parent[n])
            anc[i] = n
        groups: Dict[int, List[int]] = {}
        for row, a in enumerate(anc):
            groups.setdefault(int(a), []).append(row)
        # subtree weight = its node count (the join work it seeds)
        sizes = self._subtree_sizes()
        weight = {a: int(sizes[a]) for a in groups}
        bins: List[List[int]] = [[] for _ in range(n_shards)]
        load = [0] * n_shards
        for a in sorted(groups, key=lambda a: -weight[a]):
            i = int(np.argmin(load))
            bins[i].extend(groups[a])
            load[i] += weight[a]
        return [sorted(rows) for rows in bins]

    def shard(self, n_shards: int) -> List["TrieBank"]:
        """Split by depth-1 subtree into ``n_shards`` tries whose
        pattern sets partition the bank (see ``shard_rows``).  Each
        shard keeps the global ``nv``/``n_label_keys`` so token keys and
        psi widths stay consistent across the mesh."""
        return [
            build_trie(slice_bank(self.bank, rows))
            for rows in self.shard_rows(n_shards)
        ]

    def _subtree_sizes(self) -> np.ndarray:
        sizes = np.ones(max(self.n_nodes, 1), np.int64)
        for n in range(self.n_nodes - 1, -1, -1):
            p = int(self.node_parent[n])
            if p >= 0:
                sizes[p] += sizes[n]
        return sizes

    # ---------------------------------------------------------- checks
    def program_of(self, row: int) -> List[Tuple[int, ...]]:
        """Reconstruct pattern ``row``'s step program from its
        root-to-terminal path (testing hook)."""
        path = []
        n = int(self.terminal_node[row])
        while n >= 0:
            path.append(tuple(int(x) for x in self.node_step[n]))
            n = int(self.node_parent[n])
        return path[::-1]


def _insert_programs(
    bank: PatternBank,
    rows,
    children: Dict[Tuple[int, Tuple[int, ...]], int],
    steps: List[Tuple[int, ...]],
    parents: List[int],
    depths: List[int],
    terminal: np.ndarray,
) -> None:
    """LCP-insert the given bank rows' step programs into the node
    lists (the shared core of ``build_trie`` and ``extend_trie``)."""
    for row in rows:
        cur = -1
        for k in range(int(bank.n_steps[row])):
            srow = tuple(int(x) for x in bank.steps[row, k])
            key = (cur, srow)
            nid = children.get(key)
            if nid is None:
                nid = len(steps)
                children[key] = nid
                steps.append(srow)
                parents.append(cur)
                depths.append(1 if cur < 0 else depths[cur] + 1)
            cur = nid
        terminal[row] = cur


def _finalize_trie(
    bank: PatternBank,
    steps: List[Tuple[int, ...]],
    parents: List[int],
    depths: List[int],
    terminal: np.ndarray,
) -> TrieBank:
    """Node tables -> ``TrieBank``: subtree ``node_req`` reductions (one
    reversed pass - parent ids are always smaller than their
    children's), level index, per-level positions."""
    M = len(steps)
    node_step = np.asarray(steps, np.int32).reshape(M, STEP_FIELDS)
    node_parent = np.asarray(parents, np.int32).reshape(M)
    node_depth = np.asarray(depths, np.int32).reshape(M)
    K = bank.req.shape[1]
    big = np.iinfo(np.int32).max
    node_req = np.full((M, K), big, np.int32)
    for row in range(bank.n_patterns):
        t = int(terminal[row])
        if t >= 0:
            np.minimum(node_req[t], bank.req[row], out=node_req[t])
    for n in range(M - 1, -1, -1):
        p = int(node_parent[n])
        if p >= 0:
            np.minimum(node_req[p], node_req[n], out=node_req[p])
    # patterns of length 0 never reach compile_bank; every node has a
    # terminal somewhere below, so no +inf requirement survives
    assert M == 0 or int(node_req.max(initial=0)) < big
    levels = [
        np.nonzero(node_depth == d + 1)[0].astype(np.int32)
        for d in range(int(node_depth.max(initial=0)))
    ]
    node_pos = np.zeros(max(M, 1), np.int32)
    for nodes in levels:
        node_pos[nodes] = np.arange(len(nodes), dtype=np.int32)
    return TrieBank(node_step=node_step, node_parent=node_parent,
                    node_depth=node_depth, node_req=node_req,
                    terminal_node=terminal, bank=bank, levels=levels,
                    node_pos=node_pos[:max(M, 1)])


def build_trie(bank: PatternBank) -> TrieBank:
    """LCP-merge the bank's step programs into a ``TrieBank``.

    Node ids are assigned in first-visit order walking each program
    root-to-leaf, so every parent id is smaller than its children's and
    one reversed pass computes all subtree reductions (``node_req``)."""
    children: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    steps: List[Tuple[int, ...]] = []
    parents: List[int] = []
    depths: List[int] = []
    terminal = np.full(max(bank.n_rows, 1), -1, np.int32)
    _insert_programs(bank, range(bank.n_patterns), children, steps,
                     parents, depths, terminal)
    return _finalize_trie(bank, steps, parents, depths, terminal)


def extend_trie(trie: TrieBank, bank: PatternBank) -> TrieBank:
    """LCP-merge the appended rows of an extended bank (see
    ``bank.extend_bank``) into an existing trie without re-walking the
    old rows: ``bank`` must share rows ``[0, trie.bank.n_patterns)``
    with ``trie.bank`` (same patterns, same order).  New nodes are
    appended, so existing node ids - and every host table derived from
    them - stay valid, and the result is *identical* to
    ``build_trie(bank)`` (node ids are first-visit order over rows, and
    the shared rows visit first either way; differentially tested)."""
    old_n = trie.bank.n_patterns
    assert bank.patterns[:old_n] == trie.bank.patterns, \
        "extended bank must share its leading rows with the trie"
    children: Dict[Tuple[int, Tuple[int, ...]], int] = {
        (int(trie.node_parent[n]),
         tuple(int(x) for x in trie.node_step[n])): n
        for n in range(trie.n_nodes)
    }
    steps = [tuple(int(x) for x in trie.node_step[n])
             for n in range(trie.n_nodes)]
    parents = [int(p) for p in trie.node_parent[: trie.n_nodes]]
    depths = [int(d) for d in trie.node_depth[: trie.n_nodes]]
    terminal = np.full(max(bank.n_rows, 1), -1, np.int32)
    terminal[:old_n] = trie.terminal_node[:old_n]
    _insert_programs(bank, range(old_n, bank.n_patterns), children,
                     steps, parents, depths, terminal)
    return _finalize_trie(bank, steps, parents, depths, terminal)


def masked_node_req(trie: TrieBank, active: np.ndarray) -> np.ndarray:
    """Residual ``node_req`` rows over the *active* terminals only:
    ``min over active terminals t below n of bank.req[t]``, with
    ``REQ_MASKED`` where a subtree has no active terminal - so the
    level-synchronous scan stops joining tombstoned subtrees at their
    highest all-tombstoned ancestor (the streaming layer's tombstone
    mask; see serving.streaming).  ``active`` is a [n_patterns] bool
    mask.  With all patterns active this equals ``trie.node_req``."""
    bank = trie.bank
    M = trie.n_nodes
    node_req = np.full((max(M, 1), bank.req.shape[1]), REQ_MASKED,
                       np.int32)
    for row in range(bank.n_patterns):
        if not active[row]:
            continue
        t = int(trie.terminal_node[row])
        if t >= 0:
            np.minimum(node_req[t], bank.req[row], out=node_req[t])
    for n in range(M - 1, -1, -1):
        p = int(trie.node_parent[n])
        if p >= 0:
            np.minimum(node_req[p], node_req[n], out=node_req[p])
    return node_req[:M] if M else node_req[:0]


@dataclasses.dataclass
class SubtreePack:
    """Subtree *shards* packed into fixed slot tables - the fused
    megakernel's layout (kernels.trie_walk).  One *cell* of the
    fused walk is a (sequence, shard) pair; slot ``n`` of shard ``s``
    holds one trie node with its step row, its parent's slot index
    (-1 = shard's first node, seeded from the shared root state) and -
    gathered at serve time against the possibly-masked ``node_req`` -
    its residual prescreen row.  Slots are in ascending global node-id
    order, which is topological (parents first: node ids are assigned
    in program order), so the kernel's single unrolled pass over slots
    visits every node after its parent.

    A shard is a connected piece of one depth-1 subtree.  Small
    subtrees are one shard; subtrees wider than the slot budget
    (``width_cap``) are partitioned bottom-up into parts of bounded
    *exclusive* node count, and each part carries a replicated **spine**
    - the ancestor chain from the depth-1 root down to the part root -
    so its walk re-derives the part root's frontier in-cell with no
    cross-cell traffic.  Spine slots are walked but own no terminals
    (the part where a node is exclusive answers them); the per-node
    frontier/overflow legs along the chain are the same as in the
    unsharded walk, so the replication changes work layout, not bits.
    Without the cap, one hub subtree would set every cell's slot width
    (padding is uniform), multiplying the whole batch's walk work by
    the hub's width - the measured 10x pessimization the cap removes.

    ``roots[s]`` is the shard's *part root* (its deepest spine-free
    ancestor), not the depth-1 root: ``node_req`` is a min over the
    subtree below a node, so prescreening cells at the part root is
    both sound (any cell it skips has prescreen-dead terminals, which
    the in-kernel per-node prescreen would zero anyway - bit-identical
    by monotonicity) and strictly sharper than gating at depth 1.

    Singleton depth-1 subtrees (a childless depth-1 node) are *not*
    packed: their terminals are single-TR patterns, for which the node
    prescreen IS the exact containment test (``leaf_rows`` /
    ``leaf_roots``; the per-level scan makes the same shortcut), so the
    fused path answers them from the root prescreen with no walk and
    ``ovf=False``.

    Terminals are flat triples (``term_sub``/``term_slot``/
    ``term_rows``): bank row ``term_rows[t]`` reads its accept /
    terminal-overflow bits from slot ``term_slot[t]`` of shard
    ``term_sub[t]``."""

    node_ids: np.ndarray    # [S, Nmax] int32 global node id (-1 = pad)
    steps: np.ndarray       # [S, Nmax, STEP_FIELDS] int32 (0 = pad)
    parent: np.ndarray      # [S, Nmax] int32 parent slot (-1 root/pad)
    roots: np.ndarray       # [S] int32 root node id per packed subtree
    term_sub: np.ndarray    # [nt] int64 packed-shard index
    term_slot: np.ndarray   # [nt] int64 slot within the shard
    term_rows: np.ndarray   # [nt] int64 bank row
    term_nodes: np.ndarray  # [nt] int32 global node id of the slot
    leaf_rows: np.ndarray   # [nl] int64 singleton depth-1 leaf rows
    leaf_roots: np.ndarray  # [nl] int32 their (single) node ids

    @property
    def n_subtrees(self) -> int:
        return self.node_ids.shape[0]

    @property
    def n_slots(self) -> int:
        return self.node_ids.shape[1]

    def pack_req(self, node_req: np.ndarray) -> np.ndarray:
        """Gather the (possibly tombstone-masked, see
        ``masked_node_req``) per-node prescreen rows into slot layout:
        [S, Nmax, K] with ``REQ_MASKED`` at padding slots, so pads are
        prescreen-dead inside the kernel."""
        K = node_req.shape[1] if node_req.ndim == 2 else 0
        if not self.n_subtrees:
            return np.zeros((0, self.n_slots, K), np.int32)
        live = self.node_ids >= 0
        gathered = node_req[np.clip(self.node_ids, 0, None)]
        return np.where(live[..., None], gathered,
                        REQ_MASKED).astype(np.int32)


def _shard_group(trie: TrieBank, nodes: List[int],
                 width_cap: int) -> List[Tuple[List[int], List[int]]]:
    """Partition one depth-1 subtree (``nodes``, ascending ids, first
    is the depth-1 root) into ``(spine, exclusive)`` shards whose total
    slot width (spine + exclusive) stays within ``width_cap`` wherever
    the trie's depth allows it.

    Bottom-up greedy cut: walking nodes deepest-first, each node
    accumulates the still-uncut subtree below it; when root-path depth
    plus that accumulation would overflow the cap, the widest pending
    child subtrees are cut off as shards of their own.  A shard's spine
    is the ancestor chain from the depth-1 root to its part root's
    parent (within this subtree), replicated so the walk is
    self-contained per cell."""
    root = nodes[0]
    in_group = set(nodes)
    children: Dict[int, List[int]] = {n: [] for n in nodes}
    for n in nodes[1:]:
        children[int(trie.node_parent[n])].append(n)
    # spine length a shard rooted at n pays = #ancestors within group
    spine_len = {root: 0}
    for n in nodes[1:]:
        spine_len[n] = spine_len[int(trie.node_parent[n])] + 1
    pending: Dict[int, List[int]] = {}
    shards: List[Tuple[List[int], List[int]]] = []

    def spine_of(n: int) -> List[int]:
        path: List[int] = []
        p = int(trie.node_parent[n])
        while p >= 0 and p in in_group:
            path.append(p)
            p = int(trie.node_parent[p])
        return path[::-1]  # root first (ascending ids)

    for n in reversed(nodes):  # children before parents
        acc = [n]
        for c in children[n]:
            acc.extend(pending.pop(c, ()))
        # cut the widest pending children until this node's shard-in-
        # progress fits its worst-case width (its own spine + nodes);
        # a single node deeper than the cap degrades gracefully (the
        # caller pads nmax up)
        while spine_len[n] + len(acc) > width_cap and len(acc) > 1:
            # cut whichever uncut child subtree is widest inside acc
            by_child = [(c, [m for m in acc if m == c or _under(
                trie, m, c, in_group)]) for c in children[n]]
            by_child = [(c, ms) for c, ms in by_child if ms]
            if not by_child:
                break
            cut, cut_nodes = max(by_child, key=lambda kv: len(kv[1]))
            shards.append((spine_of(cut), sorted(cut_nodes)))
            acc = [m for m in acc if m not in set(cut_nodes)]
        pending[n] = acc
    shards.append((spine_of(root), sorted(pending[root])))
    # deterministic order: by part root id (shards of one subtree stay
    # adjacent, spine-first slot order inside each)
    shards.sort(key=lambda se: se[1][0])
    return shards


def _under(trie: TrieBank, n: int, top: int, in_group: set) -> bool:
    while n >= 0 and n in in_group:
        if n == top:
            return True
        n = int(trie.node_parent[n])
    return False


def pack_subtrees(trie: TrieBank, width_cap: int = 8) -> SubtreePack:
    """Lay the trie out as fixed-width subtree-shard slot tables for
    the fused walk (see ``SubtreePack``).  ``width_cap`` bounds each
    shard's slot count (spine + exclusive nodes); ``nmax`` is the pow-2
    of the widest shard actually produced, so one hub subtree can no
    longer inflate every cell's padded width."""
    M = trie.n_nodes
    # depth-1 ancestor per node: parents have smaller ids, one pass
    anc = np.arange(max(M, 1), dtype=np.int64)
    for n in range(M):
        p = int(trie.node_parent[n])
        if p >= 0:
            anc[n] = anc[p]
    groups: Dict[int, List[int]] = {}
    for n in range(M):
        groups.setdefault(int(anc[n]), []).append(n)  # ids ascending
    term_of: Dict[int, List[int]] = {}
    for row in range(trie.bank.n_patterns):
        t = int(trie.terminal_node[row])
        if t >= 0:
            term_of.setdefault(t, []).append(row)
    leaf_roots = [r for r in sorted(groups) if len(groups[r]) == 1]
    leaf_rows = [row for r in leaf_roots for row in term_of.get(r, ())]
    shards: List[Tuple[List[int], List[int]]] = []
    for r in sorted(groups):
        if len(groups[r]) > 1:
            shards.extend(_shard_group(trie, groups[r], width_cap))
    nmax = 1
    while nmax < max((len(sp) + len(ex) for sp, ex in shards),
                     default=1):
        nmax <<= 1
    S = len(shards)
    node_ids = np.full((S, nmax), -1, np.int32)
    steps = np.zeros((S, nmax, STEP_FIELDS), np.int32)
    parent = np.full((S, nmax), -1, np.int32)
    roots: List[int] = []
    term_sub: List[int] = []
    term_slot: List[int] = []
    term_rows: List[int] = []
    term_nodes: List[int] = []
    for s, (spine, exclusive) in enumerate(shards):
        nodes = spine + exclusive  # ascending ids == topological
        roots.append(exclusive[0])
        slot_of = {n: i for i, n in enumerate(nodes)}
        node_ids[s, : len(nodes)] = nodes
        steps[s, : len(nodes)] = trie.node_step[nodes]
        for i, n in enumerate(nodes):
            p = int(trie.node_parent[n])
            parent[s, i] = slot_of.get(p, -1)
        # only exclusive slots own terminals: spine slots are walked
        # replicas whose rows another shard answers
        for i, n in ((slot_of[n], n) for n in exclusive):
            for row in term_of.get(n, ()):
                term_sub.append(s)
                term_slot.append(i)
                term_rows.append(row)
                term_nodes.append(n)
    return SubtreePack(
        node_ids=node_ids, steps=steps, parent=parent,
        roots=np.asarray(roots, np.int32),
        term_sub=np.asarray(term_sub, np.int64),
        term_slot=np.asarray(term_slot, np.int64),
        term_rows=np.asarray(term_rows, np.int64),
        term_nodes=np.asarray(term_nodes, np.int32),
        leaf_rows=np.asarray(leaf_rows, np.int64),
        leaf_roots=np.asarray(leaf_roots, np.int32),
    )


def parent_prefix_hits(bank: PatternBank) -> int:
    """How many bank patterns have a reverse-search parent whose step
    program is a *literal* prefix of theirs (the spanning-tree edges the
    trie gets for free; canonical relabeling breaks the rest, which LCP
    merging recovers whenever the leading rows still agree)."""
    from ..core.reverse_search import parent

    hits = 0
    nl = bank.n_label_keys
    for p in bank.patterns:
        q = parent(p)
        if not q:
            continue
        pp = pattern_steps(p, nl)
        qq = pattern_steps(q, nl)
        if pp[: len(qq)] == qq:
            hits += 1
    return hits


def compile_trie_bank(
    result: Union[MiningResult, Mapping], **bank_kw
) -> TrieBank:
    """``compile_bank`` then ``build_trie``; ``MiningResult`` inputs
    additionally record the reverse-search ``parent_prefix_hits`` stat
    (raw mappings have no spanning tree - pure LCP merging)."""
    bank = compile_bank(result, **bank_kw)
    trie = build_trie(bank)
    if isinstance(result, MiningResult):
        trie.parent_prefix_hits = parent_prefix_hits(bank)
    return trie
