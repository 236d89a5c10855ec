"""Finds every piece of the benchmark by its name in ``BENCHMARK.json``.

* a configuration: ``configs/<config>.json``;
* a traffic mix: ``traffic/<traffic>.json``, data only: its ``kind``
  names the code that reads it, ``kinds/<kind>.py``, a module with a
  ``Work`` class (``setup()``, ``op()``, ``end_to_end(window_s)``,
  ``counters()``, ``checks(seed)``);
* a generator of sequences, named in a configuration:
  ``generators/<generator>.py``, a module with ``generate(params, seed)``;
* a per-layer metric: ``metrics/<metric>.py``, a module with
  ``read(art) -> float | None``;
* a kernel's operations and bytes: ``roofline/<kernel>.py``, a module with
  ``launched(*args) -> bool`` and ``counts(*args) -> (bytes, ops)``.

A new piece is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

BENCH = Path(__file__).resolve().parents[1]


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = BENCH) -> ModuleType:
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    mod_name = "bench_port_{}_{}".format(
        kind, "".join(c if c.isalnum() else "_" for c in name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str, root: Path = BENCH) -> dict:
    return load_json("configs", name, root)


def mix(name: str, root: Path = BENCH) -> dict:
    return load_json("traffic", name, root)


def kind(name: str, root: Path = BENCH) -> ModuleType:
    return load_module("kinds", name, root)


def generator(name: str, root: Path = BENCH) -> ModuleType:
    return load_module("generators", name, root)


def make_work(system, cfg: dict, mix: dict, seed: int, root: Path = BENCH):
    """The work of one run: the mix's kind, on ``system``."""
    return kind(mix["kind"], root).Work(system, cfg, mix, seed)


def metric(name: str, root: Path = BENCH) -> ModuleType:
    return load_module("metrics", name, root)


def roofline(name: str, root: Path = BENCH) -> ModuleType:
    return load_module("roofline", name, root)


def _in_cell(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell_metrics(bench: dict, cell: str) -> Tuple[List[str], List[str]]:
    """The end-to-end and the per-layer metric names a cell reports: an
    entry with a ``workloads`` key where it lists the cell; without one,
    an end-to-end metric everywhere and a per-layer metric wherever the
    metric it moves is reported."""
    e2e = [m["name"] for m in bench["end_to_end"] if _in_cell(m, cell)]
    layer = [m["name"] for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e)]
    return e2e, layer


def units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def kernels(root: Path = BENCH) -> Dict[str, ModuleType]:
    """Every kernel with a roofline file."""
    return {p.stem: roofline(p.stem, root)
            for p in sorted((root / "roofline").glob("*.py"))}
