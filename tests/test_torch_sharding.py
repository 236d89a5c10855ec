"""The port's sharding specs against the JAX package's, on the CPU: for
every arch of ``list_archs(include_extra=True)``, every shape and both
production meshes (16x16 and 2x16x16), ``arch.arg_specs`` of the step's
abstract args (params, optimizer state, batch, serve args), leaf by leaf
by path.  Each side runs in a subprocess: the port's over a fake world
of 256 / 512 ranks (its helpers read a ``DeviceMesh``), the JAX
package's over a stand-in mesh (its helpers read only ``axis_names``
and ``shape``), so no process group or device count leaks."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs.registry import list_archs

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

COMMON = r"""
import json, sys
sys.path.insert(0, "src")

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def dump(arch_ids, get_arch, specs_of, path_str, meshes, out_path):
    out = {}
    for multi, mesh in meshes:
        for arch_id in arch_ids:
            arch = get_arch(arch_id)
            for shape in arch.shapes:
                key = f"{arch_id}|{shape}|{'multi' if multi else 'single'}"
                try:
                    _, args = arch.make_step(shape)
                    out[key] = {path_str(p): [entry(e) for e in s]
                                for p, s in specs_of(arch, shape, mesh, args)}
                except Exception as e:
                    out[key] = f"raises {type(e).__name__}"
    with open(out_path, "w") as f:
        json.dump(out, f)
"""

JAX_SCRIPT = COMMON + r"""
import jax
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_arch, list_archs
from repro.models.common import path_str

class Mesh:
    def __init__(self, multi):
        self.axis_names = ("pod", "data", "model") if multi else \
            ("data", "model")
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi else (16, 16)))

def specs_of(arch, shape, mesh, args):
    specs = arch.arg_specs(shape, mesh, args)
    return jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]

dump(list_archs(include_extra=True), get_arch, specs_of, path_str,
     [(False, Mesh(False)), (True, Mesh(True))], sys.argv[1])
print("JAX-SPECS-OK")
"""

PORT_SCRIPT = COMMON + r"""
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import (path_str, tree_flatten_up_to,
                                       tree_leaves_with_path)

def specs_of(arch, shape, mesh, args):
    specs = arch.arg_specs(shape, mesh, args)
    return zip([p for p, _ in tree_leaves_with_path(args)],
               tree_flatten_up_to(args, specs))

out_path = sys.argv[1]
parts = []
for multi in (False, True):
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        dump(list_archs(include_extra=True), get_arch, specs_of, path_str,
             [(multi, mesh)], f"{out_path}.{multi}")
    with open(f"{out_path}.{multi}") as f:
        parts.append(json.load(f))
with open(out_path, "w") as f:
    json.dump({**parts[0], **parts[1]}, f)
print("PORT-SPECS-OK")
"""


def _run(script, out, tag):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script, out],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    assert tag in proc.stdout, proc.stdout + proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    work = tmp_path_factory.mktemp("specs")
    return (_run(JAX_SCRIPT, str(work / "jax.json"), "JAX-SPECS-OK"),
            _run(PORT_SCRIPT, str(work / "port.json"), "PORT-SPECS-OK"))


@pytest.mark.parametrize("arch_id", list_archs(include_extra=True))
def test_specs_match_jax(specs, arch_id):
    """Every shape, both meshes: the same leaves by path, each with the
    same spec (or both sides raise the same error, as the mining arch's
    ``make_step`` does)."""
    jax_specs, port_specs = specs
    keys = sorted(k for k in jax_specs if k.startswith(arch_id + "|"))
    assert keys and keys == sorted(
        k for k in port_specs if k.startswith(arch_id + "|"))
    for key in keys:
        assert port_specs[key] == jax_specs[key], key


def test_specs_cover_every_kind(specs):
    """The comparison is not empty: params, optimizer state, batch and
    decode-cache leaves are among the matched paths, and sharded axes
    (multi-axis DATA included) among their specs."""
    jax_specs, _ = specs
    train = jax_specs["smollm-135m|train_4k|multi"]
    assert train["0/embed"] == ["model", ["pod", "data"]]
    assert train["1/m/embed"] == train["0/embed"]
    assert train["2/tokens"] == [["pod", "data"], None]
    decode = jax_specs["smollm-135m|decode_32k|single"]
    assert decode["1/kv/sub0/k"] == [None, "data", "model", None, None]
    assert jax_specs["bert4rec|serve_p99|single"]["0/item_emb"] == \
        ["model", None]
    assert jax_specs["gtrace-mining|scan_1m|single"] == "raises RuntimeError"


def test_placements_of_specs():
    """``spec_placements``: a dim split over several mesh axes in mesh
    order is ``Shard(d)`` on each; out of the mesh's order it raises;
    one mesh axis on two dims raises."""
    code = r"""
import sys
sys.path.insert(0, "src")
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import P, dp_axes, resolve_template, \
    spec_placements, tree_shardings
with fake_world(512):
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert dp_axes(mesh) == ("pod", "data")
    spec = resolve_template(("MODEL", "DATA"), mesh)
    assert spec == ("model", ("pod", "data")) and isinstance(spec, P)
    assert spec_placements(spec, mesh) == [Shard(1), Shard(1), Shard(0)]
    assert spec_placements(P(None, ("data", "model")), mesh) == \
        [Replicate(), Shard(1), Shard(1)]
    for bad in (P(("model", "data")), P("data", "data")):
        try:
            spec_placements(bad, mesh)
        except ValueError:
            continue
        raise AssertionError(bad)
    import torch
    tree = {"embed": torch.empty(64, 32, device="meta"),
            "scale": torch.empty(64, 1, device="meta")}
    got = tree_shardings(tree, [(r"embed|scale", ("MODEL", "DATA"))], mesh)
    assert got["embed"] == [Shard(1), Shard(1), Shard(0)], got
    assert got["scale"] == [Replicate(), Replicate(), Shard(0)], got
print("PLACEMENTS-OK")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert "PLACEMENTS-OK" in proc.stdout, proc.stdout + proc.stderr[-4000:]
