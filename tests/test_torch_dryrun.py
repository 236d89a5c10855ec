"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) on the CPU, each in its own
subprocess (a fake world of 256 / 512 ranks; 512 virtual XLA devices):

* the per-rank cells (``gtrace-mining`` ``scan_1m``, ``bert4rec``
  ``serve_p99``) on both meshes: the same per-device argument bytes, the
  same collectives (count and result bytes by kind), chips, mesh and
  model FLOPs;
* an auto-sharded cell (``gcn-cora`` ``full_graph_sm``): the same
  argument bytes;
* the first trace of a DTensor matmul counts the rank's own FLOPs, not
  those DTensor spends on the global shapes to propagate shardings;
* the roofline's terms at the H100's peaks."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun
from repro_torch.roofline import analysis

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PER_RANK = [("gtrace-mining", "scan_1m"), ("bert4rec", "serve_p99")]
AUTO = [("gcn-cora", "full_graph_sm")]
MESHES = ("single", "multi")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both dry runs of every cell above, run side by side."""
    work = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    procs = []
    for side, module, extra in (("jax", "repro.launch.dryrun", []),
                                ("port", "repro_torch.launch.dryrun",
                                 ["--device", "cpu"])):
        for arch, shape in PER_RANK + AUTO:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, "--arch", arch, "--shape",
                 shape, "--mesh", "both", "--out", str(work / side)] + extra,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=ROOT, env=env))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    got = {}
    for side in ("jax", "port"):
        for arch, shape in PER_RANK + AUTO:
            for mesh in MESHES:
                with open(work / side / f"{arch}__{shape}__{mesh}.json") as f:
                    got[side, arch, shape, mesh] = json.load(f)
    return got


def _pair(runs, arch, shape, mesh):
    j, t = runs["jax", arch, shape, mesh], runs["port", arch, shape, mesh]
    assert j["ok"], j.get("error")
    assert t["ok"], t.get("traceback")
    return j, t


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", PER_RANK)
def test_per_rank_cells_match_jax(runs, arch, shape, mesh):
    j, t = _pair(runs, arch, shape, mesh)
    for key in ("n_chips", "mesh"):
        assert t[key] == j[key], key
    assert t["roofline"]["model_flops"] == j["roofline"]["model_flops"]
    assert t["memory"]["argument_size_in_bytes"] == \
        j["memory"]["argument_size_in_bytes"]
    assert t["collectives"] == j["collectives"]
    assert t["roofline"]["collective_bytes_per_chip"] == sum(
        d["bytes"] for d in j["collectives"].values())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", AUTO)
def test_auto_sharded_argument_bytes_match_jax(runs, arch, shape, mesh):
    j, t = _pair(runs, arch, shape, mesh)
    assert t["memory"]["argument_size_in_bytes"] == \
        j["memory"]["argument_size_in_bytes"]
    assert t["replicated_fallbacks"] == {}


def test_mining_cell_sees_the_kernel_by_name(runs):
    """The match_count custom op shows in the trace: one call per rank,
    its inputs (the rank's blocks) and its [E, T] output counted."""
    t = runs["port", "gtrace-mining", "scan_1m", "single"]
    k = t["kernels"]["repro_torch::match_count"]
    assert k["calls"] == 1
    # tokens [65536, 8, 6] + gid/phi/psi/valid/pid of 256 rows + one
    # 64-row pattern table + 3 scalars in, sigs [256, 8] out
    assert k["bytes"] == 4 * (65536 * 8 * 6 + 256 * (1 + 16 + 12 + 1 + 1)
                              + 64 * 5 + 3 + 256 * 8)
    assert t["memory"]["temp_size_in_bytes"] > 0


def test_first_trace_counts_local_flops():
    """[8192, 4096] S(0)R @ [4096, 8192] S(0)S(1) on 16x16: on its first
    trace the rank counts its own 2*512*4096*512 FLOPs (DTensor first
    runs the op on the global shapes to propagate the sharding, which
    would count 2*8192*4096*8192 more), and the all-gather of the
    right-hand side over "data"."""
    code = r"""
import sys
sys.path.insert(0, "src")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import _Counter, fake_world
from repro_torch.launch.mesh import make_production_mesh
with fake_world(256):
    mesh = make_production_mesh(device="cpu")
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(512, 4096), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(256, 512), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        counter = _Counter([a._local_tensor, b._local_tensor])
        with counter:
            c = a @ b
        assert tuple(c.to_local().shape) == (512, 512)
print("FLOPS", counter.flops, "GATHER", counter.collectives)
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    line = [x for x in proc.stdout.splitlines() if x.startswith("FLOPS")]
    assert line, proc.stdout + proc.stderr[-4000:]
    _, flops, _, gather = line[0].split(" ", 3)
    assert int(flops) == 2 * 512 * 4096 * 512
    assert json.loads(gather.replace("'", '"')) == {
        "all-gather": {"bytes": 4096 * 512 * 4, "count": 1}}


def test_roofline_terms_and_bottleneck():
    P = analysis.PEAK_FLOPS
    r = analysis.Roofline(flops_per_chip=P,
                          hbm_bytes_per_chip=analysis.HBM_BW / 2,
                          collective_bytes_per_chip=analysis.LINK_BW * 2,
                          n_chips=4, model_flops=4 * P / 2)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9
    assert r.bottleneck == "collective"
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    assert abs(r.roofline_fraction - 0.25) < 1e-9
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)


def test_collectives_counted_by_kind():
    """Result bytes by XLA's kind names, as ``parse_collectives`` sums
    them; waits and non-collectives are not counted."""
    import torch

    table = {}
    ops = torch.ops
    assert analysis.count_collective(
        table, ops.c10d.allreduce_.default, ([torch.empty(16, 128)], None))
    assert analysis.count_collective(
        table, ops._c10d_functional.all_gather_into_tensor.default,
        torch.empty(4, 256, dtype=torch.bfloat16))
    assert analysis.count_collective(
        table, ops.c10d.allgather_.default,
        ([[torch.empty(8), torch.empty(8)]], None))
    assert not analysis.count_collective(
        table, ops._c10d_functional.wait_tensor.default, torch.empty(8))
    assert not analysis.count_collective(table, ops.aten.mm.default,
                                         torch.empty(8, 8))
    assert table == {"all-reduce": {"bytes": 16 * 128 * 4, "count": 1},
                     "all-gather": {"bytes": 4 * 256 * 2 + 2 * 8 * 4,
                                    "count": 2}}
    r = analysis.from_counts(10.0, 20.0, table, 256, 5.0)
    assert r.collective_bytes_per_chip == 16 * 128 * 4 + 4 * 256 * 2 + 64
    assert r.to_dict()["collectives_by_kind"] == table


def test_failing_cell_is_written(tmp_path):
    """A cell whose trace raises is written ``ok: false`` with its error
    and traceback, as the JAX module writes it."""
    res = dryrun.run_cell_to_file("no-such-arch", "train_4k", False,
                                  str(tmp_path), "cpu")
    with open(tmp_path / "no-such-arch__train_4k__single.json") as f:
        assert json.load(f) == res
    assert res["ok"] is False and "no-such-arch" in res["error"]
    assert "Traceback" in res["traceback"]
