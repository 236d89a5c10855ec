#!/usr/bin/env python3
"""Run the control of a cell: the reference, with one exactness guarantee
broken (``reference/control.py``), in the program's place, at the cell's
own size and load, on several seeds.  The comparison that decides
``correct`` has to fail it on every seed; the readings it gives are the
upper readings the limits in PERF.md were set from.

    python3 bench_port/control.py --workload t3.query_cold --seconds 3 \\
        --seeds 2147483801 2147483802 2147483803

Prints one JSON line a seed: the compared numbers and whether the run
came out correct.  The benchmark's own runs never run this.  It runs on
the host and needs no card.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench_port.lib import driver, registry
    from bench_port.lib.systems import ControlSystem

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    e2e, _ = registry.cell_metrics(bench, cell["name"])
    # mining cells: the capped miner; serving cells: an exact bank and
    # the capped frontier, so that the serving layer's shortcut is judged
    system = ControlSystem(per_seq=1 if mix["kind"] == "mine" else None)
    for seed in args.seeds:
        res = driver.run(cfg, mix, seed, args.seconds, False, {},
                         system, {})
        print(json.dumps({
            "workload": cell["name"], "seed": seed,
            "attempted": res["attempted"],
            "correct": driver.is_correct(res, res["end_to_end"], e2e),
            "checks": {c["name"]: c["value"] for c in res["checks"]}}),
            flush=True)


if __name__ == "__main__":
    main()
