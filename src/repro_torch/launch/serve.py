"""Serving launcher: mine an rFTS bank, stand up a PatternServer, and
drive a synthetic query workload end to end.

    python -m repro_torch.launch.serve --device cuda --bank-layout trie_fused

On ``cuda`` every join predicate launches the containment kernel, every
fused walk the trie-walk kernel and every mining scan the match_count
kernel; ``--device cpu`` runs their plain PyTorch versions instead.
There is no ``--use-kernel``: the device decides, and there is no silent
fallback from one to the other.

With ``--window N`` the launcher instead stands up a ``StreamingBank``:
the mined DB seeds an N-sequence sliding window, the query stream is
observed batch by batch (supports maintained incrementally, tombstones
masked), and ``--refresh-every R`` reconciles the bank with the window
every R batches via the frontier re-mine.

    python -m repro_torch.launch.serve --db-size 100 --queries 200 \
        --window 100 --refresh-every 4 --bank-layout trie

``--hosts N`` (N > 1) stands the bank up as a cluster of simulated
hosts (``serving.cluster``, all on ``--device``): queries arrive round
robin across hosts and are routed through per-shard batches; with
``--window`` the cluster runs the sharded-window streaming protocol
instead (per-host ring slices, supports summed at refresh).
``--replicas R`` (streaming mode) adds R read replicas behind a single
writer and serves the query sample from a replica after shipping the
writer's deltas.

    python -m repro_torch.launch.serve --db-size 100 --queries 200 \
        --hosts 4 --bank-layout trie

Every mode ends by checking itself and printing "(verified)": the
single host and the cluster hold the first ``--verify`` queries' rows
to the host oracle (``core.containment.contains``); the streaming modes
hold the final frequent map to a batch re-mine of the window, and a
replica's rows to the writer's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.containment import contains
from ..core.graphseq import pattern_str
from ..data.synthetic import Table3Params, generate_table3_db
from ..mining.driver import AcceleratedMiner
from ..serving.bank import compile_bank
from ..serving.layouts import get_layout
from ..serving.server import PatternServer
from ..serving.streaming import StreamingBank
from ..serving.trie import build_trie


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=150)
    ap.add_argument("--v-avg", type=int, default=5)
    ap.add_argument("--interstates", type=int, default=3)
    ap.add_argument("--min-support-frac", type=float, default=0.1)
    ap.add_argument("--max-len", type=int, default=4)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--emax", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--top-patterns", type=int, default=None,
                    help="serve only the strongest N patterns")
    ap.add_argument("--bank-layout",
                    choices=("flat", "trie", "trie_fused"),
                    default="flat",
                    help="flat per-pattern joins, or the prefix-trie "
                         "layout that joins shared rFTS prefixes once")
    ap.add_argument("--window", type=int, default=None,
                    help="streaming mode: maintain supports over a "
                         "sliding window of this many sequences")
    ap.add_argument("--refresh-every", type=int, default=4,
                    help="streaming mode: reconcile (frontier re-mine) "
                         "every N observed batches")
    ap.add_argument("--stream-batch", type=int, default=25,
                    help="streaming mode: arrivals per observed batch")
    ap.add_argument("--hosts", type=int, default=1,
                    help="multi-host cluster: shard the bank across "
                         "this many simulated hosts (with --window, "
                         "run the sharded-window streaming protocol)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="streaming mode: read replicas behind the "
                         "single writer (deltas shipped per refresh)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", type=int, default=16,
                    help="hold this many queries' rows to the host oracle")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the serving kernels) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args()

    params = Table3Params(db_size=args.db_size, v_avg=args.v_avg,
                          n_interstates=args.interstates)
    db = generate_table3_db(params, seed=args.seed)
    sigma = max(2, int(args.min_support_frac * len(db)))
    if args.window is not None and args.hosts > 1:
        return _sharded_stream_main(args, db, sigma)
    if args.window is not None:
        return _stream_main(args, db, sigma)
    if args.hosts > 1:
        return _cluster_main(args, db, sigma)
    print(f"[serve] mining |DB|={len(db)} sigma={sigma} "
          f"max_len={args.max_len} device={args.device}")
    miner = AcceleratedMiner(db, device=args.device)
    t0 = time.time()
    res = miner.mine_rs(sigma, max_len=args.max_len,
                        checkpoint_path=args.checkpoint,
                        resume=args.resume)
    bank = compile_bank(res, top=args.top_patterns)
    print(f"[serve] bank: {bank.n_patterns} rFTSs "
          f"(max {bank.max_steps} TRs, {bank.nv} vertices) "
          f"mined in {time.time()-t0:.2f}s")
    trie = None
    if get_layout(args.bank_layout).uses_trie:
        trie = build_trie(bank)
        print(f"[serve] trie: {trie.n_nodes} nodes, depth {trie.depth},"
              f" sharing x{trie.sharing_ratio:.2f}")

    srv = PatternServer(bank, emax=args.emax, max_batch=args.max_batch,
                        topk=args.topk, bank_layout=args.bank_layout,
                        trie=trie, device=args.device)
    queries = _queries(args)
    srv.query(queries[: min(len(queries), args.max_batch)])  # warm up
    srv._cache.clear()
    t0 = time.time()
    results = srv.query(queries)
    dt = time.time() - t0
    n_hits = sum(len(r.pattern_ids) for r in results)
    print(f"[serve] {len(queries)} queries in {dt:.3f}s "
          f"({len(queries)/max(dt, 1e-9):.0f} qps), "
          f"{n_hits} containments, stats={srv.stats}")
    best = results[0]
    print(f"[serve] sample top-{args.topk} for query 0:")
    for pid, sup in best.topk:
        print(f"    [{sup:3d}] {pattern_str(bank.patterns[pid])}")
    # second pass: everything cache-served
    t0 = time.time()
    srv.query(queries)
    print(f"[serve] cached pass {time.time()-t0:.3f}s, "
          f"cache_hits={srv.stats['cache_hits']}")
    _verify_rows(bank, queries, results, args.verify)


def _queries(args):
    qparams = Table3Params(db_size=args.queries, v_avg=args.v_avg,
                           n_interstates=args.interstates)
    return generate_table3_db(qparams, seed=args.seed + 1)


def _verify_rows(bank, queries, results, n):
    """Hold the first ``n`` queries' served rows to the host oracle."""
    n = min(n, len(queries))
    shape = (n, bank.n_patterns)
    got = np.array([r.contained for r in results[:n]], bool).reshape(shape)
    want = np.array([[contains(p, s) for p in bank.patterns]
                     for s in queries[:n]], bool).reshape(shape)
    if not np.array_equal(got, want):
        raise SystemExit(f"[serve] rows differ from the host oracle in "
                         f"{int((got != want).sum())} cells")
    print(f"[serve] first {n} queries == host oracle  (verified)")


def _verify_window(freq, window_seqs, args, sigma):
    """Hold a streaming bank's frequent map to a batch re-mine of its
    window."""
    want = AcceleratedMiner(window_seqs, device=args.device).mine_rs(
        sigma, max_len=args.max_len).patterns
    if freq != want:
        raise SystemExit(f"[serve] frequent map ({len(freq)} rFTSs) "
                         f"differs from a batch re-mine of the window "
                         f"({len(want)})")
    print(f"[serve] {len(freq)} frequent == batch re-mine of the "
          f"{len(window_seqs)}-sequence window  (verified)")


def _cluster_main(args, db, sigma):
    """Multi-host serving: shard the mined bank across simulated hosts,
    spread the query stream round robin over arrival hosts, and route it
    through shared per-shard batches."""
    from ..serving.cluster import ServingCluster

    print(f"[serve] cluster: mining |DB|={len(db)} sigma={sigma} "
          f"max_len={args.max_len}, {args.hosts} hosts, "
          f"device={args.device}")
    miner = AcceleratedMiner(db, device=args.device)
    res = miner.mine_rs(sigma, max_len=args.max_len)
    bank = compile_bank(res, top=args.top_patterns)
    cl = ServingCluster(
        bank, args.hosts, bank_layout=args.bank_layout,
        topk=args.topk, emax=args.emax, max_batch=args.max_batch,
        device=args.device,
    )
    sizes = [len(h.rows) for h in cl.hosts]
    print(f"[serve] bank: {bank.n_patterns} rFTSs sharded "
          f"{sizes} across {args.hosts} hosts ({args.bank_layout})")
    queries = _queries(args)
    reqs = {h: [] for h in range(args.hosts)}
    for i, s in enumerate(queries):
        reqs[i % args.hosts].append(s)
    cl.query_multi(reqs)  # warm up
    cl.router.clear_caches()
    t0 = time.time()
    got = cl.query_multi(reqs)
    dt = time.time() - t0
    n_hits = sum(len(r.pattern_ids) for rs in got.values() for r in rs)
    print(f"[serve] routed {len(queries)} queries in {dt:.3f}s "
          f"({len(queries)/max(dt, 1e-9):.0f} qps), {n_hits} "
          f"containments, stats={cl.router.stats}")
    # replay from the *other* hosts: everything L2- or L1-served
    reqs2 = {(h + 1) % args.hosts: v for h, v in reqs.items()}
    t0 = time.time()
    cl.query_multi(reqs2)
    print(f"[serve] cross-host replay {time.time()-t0:.3f}s, "
          f"l1={cl.router.stats['l1_hits']} "
          f"l2={cl.router.stats['l2_hits']}")
    # query i arrived on host i % hosts as its (i // hosts)-th request
    results = [got[i % args.hosts][i // args.hosts]
               for i in range(len(queries))]
    _verify_rows(bank, queries, results, args.verify)


def _sharded_stream_main(args, db, sigma):
    """Sharded-window streaming: per-host ring slices, routed arrival
    joins, supports summed over the slices at each refresh."""
    from ..serving.cluster import ShardedStreamingBank

    # ring slices must divide the window evenly; round up so a window
    # smaller than the host count still yields one slot per host
    window = max(1, -(-args.window // args.hosts)) * args.hosts
    print(f"[serve] sharded window: |DB|={len(db)} sigma={sigma} "
          f"window={window} over {args.hosts} hosts, device={args.device}")
    t0 = time.time()
    sb = ShardedStreamingBank.from_db(
        db, minsup=sigma, n_hosts=args.hosts, window=window,
        max_len=args.max_len, bank_layout=args.bank_layout,
        emax=args.emax, device=args.device,
    )
    print(f"[serve] seeded in {time.time()-t0:.2f}s: "
          f"{sb.bank.n_patterns} rFTSs")
    stream = _queries(args)
    t0 = time.time()
    for i in range(0, len(stream), args.stream_batch):
        sb.observe(stream[i: i + args.stream_batch])
        if (i // args.stream_batch + 1) % args.refresh_every == 0:
            sb.refresh()
    freq = sb.refresh()
    dt = time.time() - t0
    print(f"[serve] streamed {len(stream)} arrivals in {dt:.3f}s "
          f"({len(stream)/max(dt, 1e-9):.0f} updates/s), "
          f"{len(freq)} frequent after final refresh; stats={sb.stats}")
    top = sorted(freq.items(), key=lambda ps: -ps[1])[: args.topk]
    print(f"[serve] top-{args.topk} by summed window support:")
    for p, sup in top:
        print(f"    [{sup:3d}] {pattern_str(p)}")
    _verify_window(freq, sb.window_seqs, args, sigma)


def _stream_main(args, db, sigma):
    """Streaming mode: seed a window, observe the query stream,
    reconcile on a cadence, report support drift and frontier stats."""
    print(f"[serve] streaming: mining seed window |DB|={len(db)} "
          f"sigma={sigma} max_len={args.max_len} device={args.device}")
    t0 = time.time()
    sb = StreamingBank.from_db(
        db, minsup=sigma, window=args.window, max_len=args.max_len,
        bank_layout=args.bank_layout, refresh_every=args.refresh_every,
        emax=args.emax, device=args.device,
    )
    group = None
    if args.replicas:
        from ..serving.cluster import ReplicaGroup
        group = ReplicaGroup(sb, args.replicas)
        print(f"[serve] writer + {args.replicas} read replicas")
    print(f"[serve] seeded in {time.time()-t0:.2f}s: "
          f"{sb.bank.n_patterns} rFTSs, {len(sb.frequent())} frequent "
          f"over the {args.window}-seq window")
    stream = _queries(args)
    t0 = time.time()
    for i in range(0, len(stream), args.stream_batch):
        batch = stream[i: i + args.stream_batch]
        r = sb.observe(batch)
        print(f"[serve] batch {i // args.stream_batch}: "
              f"+{r.arrived}/-{r.evicted} seqs, "
              f"{r.tombstoned} tombstoned"
              + (", refreshed" if r.refreshed else ""))
    freq = sb.refresh()
    dt = time.time() - t0
    print(f"[serve] streamed {len(stream)} arrivals in {dt:.3f}s "
          f"({len(stream)/max(dt, 1e-9):.0f} updates/s), "
          f"{len(freq)} frequent after final refresh; stats={sb.stats}")
    top = sorted(freq.items(), key=lambda ps: -ps[1])[: args.topk]
    print(f"[serve] top-{args.topk} by live window support:")
    for p, sup in top:
        print(f"    [{sup:3d}] {pattern_str(p)}")
    _verify_window(freq, sb.window_seqs, args, sigma)
    if group is not None:
        sample = stream[: min(len(stream), 8)]
        print(f"[serve] replica lag before ship: "
              f"{group.lag(0)} deltas")
        group.sync()
        got = group.query(sample, replica=0, k=args.topk)
        n_hits = sum(len(r.pattern_ids) for r in got)
        print(f"[serve] replica 0 serves {len(sample)} sample queries "
              f"after ship: {n_hits} containments")
        want = sb.server.exact_rows(sample)
        if not np.array_equal(np.stack([r.contained for r in got]), want):
            raise SystemExit("[serve] replica rows differ from the "
                             "writer's")
        print(f"[serve] replica 0 rows == writer rows on {len(sample)} "
              f"sample queries  (verified)")


if __name__ == "__main__":
    main()
