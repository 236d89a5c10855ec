"""BENCHMARK.json against its schema and limits, and every piece found by
name: the configurations, the traffic mixes, the per-layer metrics and
the kernels' rooflines, plus a new one of each added as a file in a copy."""
import json
import re
import shutil
from pathlib import Path

import pytest

from bench_port.lib import registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_tok)")


def _line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell) fits 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 2 * 90 + 1200 <= 43200


def test_configs_cells_and_metrics_follow_the_schema():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(configs) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert {w["config"] for w in cells} == set(configs)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            # every listed cell reports the metric it moves
            assert m["moves"] in registry.cell_metrics(BENCH, w)[0]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        e, p = registry.cell_metrics(BENCH, w["name"])
        assert "setup_s" in e and len(e) >= 2 and p


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = registry.config(w["config"])
    mix = registry.mix(w["traffic"])
    assert cfg["name"] == w["config"]
    assert callable(registry.kind(mix["kind"]).Work)
    for block in ("db", "query_pool"):
        if block in cfg:
            assert callable(registry.generator(cfg[block]["generator"])
                            .generate)
    _, layer = registry.cell_metrics(BENCH, cell)
    for name in layer:
        assert callable(registry.metric(name).read)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(registry.BENCH)) for folder in ("kinds", "generators")
    for p in (registry.BENCH / folder).glob("*.py")))
def test_every_kind_and_generator_file_is_found_by_its_name(path):
    folder, name = Path(path).parent.name, Path(path).stem
    if folder == "kinds":
        work = registry.kind(name).Work
        for method in ("setup", "op", "end_to_end", "counters", "checks"):
            assert callable(getattr(work, method))
    else:
        assert callable(registry.generator(name).generate)


def test_every_kernel_roofline_is_found():
    kernels = registry.kernels()
    assert set(kernels) >= {"match_count", "contain_step"}
    for mod in kernels.values():
        assert isinstance(mod.KERNEL, str) and mod.WRAPS
        assert callable(mod.counts) and callable(mod.launched)


def test_a_new_piece_is_a_new_file(tmp_path):
    """A later change adds a config, a mix, a metric and a roofline as
    files, and the registry finds them with no other edit."""
    root = tmp_path / "bench_port"
    for kind in ("configs", "traffic", "metrics", "roofline", "kinds",
                 "generators"):
        shutil.copytree(registry.BENCH / kind, root / kind)
    cfg = registry.config("gtrace-t3", root)
    cfg["name"] = "gtrace-t3-trie"
    cfg["server"]["bank_layout"] = "trie_fused"
    (root / "configs" / "gtrace-t3-trie.json").write_text(json.dumps(cfg))
    (root / "traffic" / "query_small.json").write_text(json.dumps(
        dict(registry.mix("query_cold", root), batch=32)))
    (root / "metrics" / "serve.dummy_ms.py").write_text(
        "def read(art):\n    return 1.5\n")
    (root / "roofline" / "trie_walk.py").write_text(
        "KERNEL = 'trie_walk_kernel'\n"
        "WRAPS = [('repro_torch.serving.batch', 'trie_walk_cells')]\n"
        "def launched(*a):\n    return True\n"
        "def counts(*a):\n    return 8, 2\n")
    (root / "kinds" / "stream.py").write_text(
        "class Work:\n    def __init__(self, system, cfg, mix, seed):\n"
        "        self.arrivals = mix['arrivals']\n")
    (root / "traffic" / "stream.json").write_text(json.dumps(
        {"kind": "stream", "arrivals": 50}))
    (root / "generators" / "fixed.py").write_text(
        "def generate(params, seed):\n    return [()] * params['n']\n")
    assert registry.make_work(None, cfg, registry.mix("stream", root), 1,
                              root).arrivals == 50
    assert registry.generator("fixed", root).generate({"n": 3}, 0) == [()] * 3
    assert registry.config("gtrace-t3-trie", root)["server"][
        "bank_layout"] == "trie_fused"
    assert registry.mix("query_small", root)["batch"] == 32
    assert registry.metric("serve.dummy_ms", root).read(None) == 1.5
    assert registry.kernels(root)["trie_walk"].counts() == (8, 2)
    with pytest.raises(FileNotFoundError):
        registry.metric("serve.absent", root)
