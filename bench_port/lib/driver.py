"""One run of one cell: set-up, the measured window, the traced slice, the
check.

``--trace 0``: set-up, then ops back to back until ``seconds`` have passed
(every op started inside the window runs to its end, and the window ends
with it), then the end-to-end metrics.  ``--trace 1``: the same set-up and
window with the program's spans recorded (``obs.trace`` sampled at rate 1:
every span, no device fences), counters read around it, then a slice of
``profile_ops`` more ops under ``torch.profiler`` with the kernels' inputs
recorded; the per-layer readers take their numbers from these artifacts.

Then, in both, the peak device memory since the process started is read,
and the reference, on the host, judges the outputs (``check``).
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

from . import registry, timeline

BENCH = Path(__file__).resolve().parents[1]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a templated kernel's name runs to thousands of characters
OP_NAME_CHARS = 120


def _window(work, seconds: float) -> tuple:
    """Ops back to back until ``seconds`` have passed; returns (window
    seconds, ops, units, failed)."""
    import torch

    t0 = time.perf_counter()
    n = units = failed = 0
    while True:
        try:
            units += work.op()
        except Exception:  # the run goes on to report the failure
            failed += 1
            traceback.print_exc(file=sys.stderr)
            break
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0, n, units, failed


def int32_peak() -> float:
    """The card's int32 peak, ops/s: int32 ops an SM issues a clock (the
    peaks table) x its SMs x its maximum SM clock (nvidia-smi)."""
    import torch

    peaks = json.loads((BENCH / "roofline" / "peaks.json").read_text())
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return peaks["int32_ops_per_sm_clock"] * sms * mhz * 1e6


def _label_points(spans: List[tuple], points: List[float]) -> List[str]:
    """The innermost span (``(start, end, name)``, properly nested)
    around each of the sorted ``points``."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no span: harness loop)")
    return out


def profile_slice(work, n_ops: int, trace) -> SimpleNamespace:
    """``n_ops`` ops under ``torch.profiler`` (CPU and CUDA activity).
    A ``bench.align`` marker, recorded both as a profiler annotation and
    as a span at one host time, puts the program's spans on the
    profiler's clock, so each idle gap can be named by the span the host
    was in."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with trace.root_or_span("bench.align"):
            with record_function("bench.align"):
                t_align = time.perf_counter()
                trace.add_complete("bench.align", "host", t_align, 0.0)
        for _ in range(n_ops):
            work.op()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_align
    spans = list(trace.tracer.events)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        doc = json.loads(Path(path).read_text())
    finally:
        os.unlink(path)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    lo = next(e["ts"] for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == "bench.align")
    hi = lo + 1e6 * wall
    device = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
              for e in events if e.get("cat") in DEVICE_CATS
              and lo <= e["ts"] <= hi]
    busy = timeline.union([(ts, ts + d) for _, _, ts, d in device])
    idle = timeline.gaps(busy, lo, hi)
    # span ts (us from the tracer's base) -> profiler us
    align = next(s for s in spans if s["name"] == "bench.align"
                 and s["cat"] == "host")
    shift = lo - align["ts"]
    named = [(s["ts"] + shift, s["ts"] + s["dur"] + shift, s["name"])
             for s in spans if s["name"] != "bench.align"]
    labels = _label_points(named, [(s + e) / 2 for s, e in idle])
    by_label: Dict[str, float] = {}
    for (s, e), lab in zip(idle, labels):
        by_label[lab] = by_label.get(lab, 0.0) + (e - s) / 1e6
    by_op: Dict[str, float] = {}
    for name, _, _, d in device:
        name = name[:OP_NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + d / 1e6
    return SimpleNamespace(
        ops=n_ops, wall_s=wall, busy_s=timeline.covered(busy) / 1e6,
        device=device,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(by_label.items(), key=lambda kv: -kv[1])[:10])


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        readers: Dict, system, roofline: Dict,
        t_start: Optional[float] = None) -> dict:
    """One run; returns ``{"attempted", "failed", "end_to_end",
    "per_layer", "checks", "memory_peak_bytes", "trace"}``.
    ``readers``: per-layer metric name -> reader module; ``roofline``:
    kernel name -> roofline module."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_cuda = torch.cuda.is_available() and getattr(
        system, "device", "cuda") == "cuda"
    work = registry.make_work(system, cfg, mix, seed)
    work.setup()
    # the inputs made in set-up (a pool of 16,384 sequences is a million
    # tuples) stay alive all run: out of the collector's way, so that its
    # full passes cost the window what the program's own objects cost
    gc.collect()
    gc.freeze()
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    out = {"end_to_end": {}, "per_layer": {}, "trace": None}
    if not traced:
        window_s, n, units, failed = _window(work, seconds)
        if n:
            out["end_to_end"] = dict(work.end_to_end(window_s),
                                     setup_s=setup_s)
    else:
        from repro_torch.obs import trace

        trace.enable_sampling(1.0)
        trace.clear()
        c0 = work.counters()
        window_s, n, units, failed = _window(work, seconds)
        c1 = work.counters()
        spans = timeline.self_times(list(trace.tracer.events))
        calls: Dict[str, list] = {}
        sl = None
        if not failed and on_cuda:
            with system.recording(calls, roofline):
                sl = profile_slice(work, mix["profile_ops"], trace)
        trace.disable()
        trace.clear()
        art = SimpleNamespace(
            kind=mix["kind"], ops=n, window_s=window_s,
            counters={k: c1[k] - c0.get(k, 0) for k in c1},
            spans=spans, slice=sl, calls=calls, roofline=roofline,
            peaks=None)
        if sl is not None:
            art.peaks = {
                "hbm_bytes_per_s": json.loads(
                    (BENCH / "roofline" / "peaks.json").read_text()
                )["hbm_bytes_per_s"],
                "int32_ops_per_s": int32_peak()}
        for name, mod in readers.items():
            v = mod.read(art) if n else None
            if v is not None:
                out["per_layer"][name] = v
        if sl is not None:
            out["trace"] = sl
        del art, calls
    out["attempted"] = units
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if on_cuda else 0)
    # the reference runs on the host, after the window's garbage is gone
    gc.unfreeze()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    out["checks"] = work.checks(seed)
    out["failed"] = failed
    return out


def is_correct(res: dict, reported: Dict, names: List[str]) -> bool:
    """A run is correct when no op failed, at least one was attempted,
    every compared number is within its limit, and every metric the cell
    reports was read (``reported``: the metrics read, ``names``: those
    the cell reports)."""
    return (res["failed"] == 0 and res["attempted"] > 0
            and all(c["value"] <= c["limit"] for c in res["checks"])
            and all(n in reported for n in names))
