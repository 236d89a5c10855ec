#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload t3.mine --seed 17 --seconds 20 --trace 0

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, traffic mix and per-layer metrics by name under
``bench_port/`` (``lib/registry.py``), runs set-up, the measured window and
the check on the one CUDA card (``lib/driver.py``), and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error).

Exits non-zero without a result when there is no CUDA card (or fewer
than the cell asks for), when the port's package is not beside the
benchmark, and when JAX or the JAX package is loaded once the window has
closed.  Set-up time runs from the start of this script.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _fail(msg: str, code: int) -> None:
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        _fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(f"the port's package is not at {ROOT / 'src' / 'repro_torch'}",
              2)
    # the checkout's root (for ``bench_port``) and the port's ``src``;
    # not the script's own folder, whose ``lib`` would shadow nothing
    # but is no package root
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != BENCH]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        _fail(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", 3)

    from bench_port.lib import driver, guard, registry
    from bench_port.lib.systems import ProgramSystem

    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    e2e, layer = registry.cell_metrics(bench, cell["name"])
    traced = bool(args.trace)
    readers = {n: registry.metric(n) for n in layer} if traced else {}
    res = driver.run(cfg, mix, args.seed, args.seconds, traced,
                     readers, ProgramSystem("cuda"),
                     registry.kernels() if traced else {}, t_start=T0)

    found = guard.loaded_forbidden()
    if found:
        _fail("the run loaded " + ", ".join(found) + ": the benchmark "
              "measures the PyTorch port alone", 4)

    unit = registry.units(bench)
    values = res["per_layer"] if traced else res["end_to_end"]
    names = layer if traced else e2e
    metrics = {n: {"value": values[n], "unit": unit[n]}
               for n in names if n in values}
    checks = res["checks"]
    correct = driver.is_correct(res, values, names)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit": _power_limit()}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    sl = res["trace"]
    if sl is not None:
        device["busy_s"] = sl.busy_s
        device["window_s"] = sl.wall_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in sl.device_ops],
                            "idle_gaps": [[n, s] for n, s in sl.idle_gaps]}
    missing = [n for n in names if n not in values]
    if missing:
        print("bench_port: not read: " + ", ".join(missing), file=sys.stderr)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    for c in checks:
        print(f"check {c['name']} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
