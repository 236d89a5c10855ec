"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, and no source file of it (or chip_smoke.py, or the
multi-rank tests' worker) imports them.  And it mirrors the JAX
package's public surface: every public name of a mirrored JAX module
exists on the port's counterpart."""
import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PORT_FILES = sorted(
    glob.glob(os.path.join(SRC, "repro_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py")] + [
    os.path.join(ROOT, "tests", name) for name in
    ("torch_dist_worker.py", "test_torch_distributed_cuda.py",
     "test_torch_models_cuda.py", "torch_lm_checks.py")]
# JAX package module -> the port's counterpart, held name for name
SURFACES = {
    "repro.serving": "repro_torch.serving",
    "repro.obs": "repro_torch.obs",
    "repro.mining.engine": "repro_torch.mining.engine",
    "repro.mining.distributed": "repro_torch.mining.distributed",
    "repro.serving.sharded": "repro_torch.serving.sharded",
    "repro.launch.mesh": "repro_torch.launch.mesh",
    "repro.models.layers": "repro_torch.models.layers",
    "repro.models.attention": "repro_torch.models.attention",
    "repro.models.moe": "repro_torch.models.moe",
    "repro.models.transformer": "repro_torch.models.transformer",
    "repro.models.common": "repro_torch.models.common",
    "repro.training.optimizer": "repro_torch.training.optimizer",
    "repro.training.checkpoint": "repro_torch.training.checkpoint",
    "repro.training.train_loop": "repro_torch.training.train_loop",
    "repro.data.lm": "repro_torch.data.lm",
    "repro.configs.base": "repro_torch.configs.base",
    "repro.configs.families": "repro_torch.configs.families",
    "repro.configs.registry": "repro_torch.configs.registry",
}
# Names of a mirrored module that later slices of the port bring, and
# nothing else: the GNN / MACE / recsys archs (slice 8), the sharding
# helpers of the dry-run (slice 9).
LATER_SLICES = {
    "repro.models.common": {"Rules", "dp_axes", "resolve_template",
                            "tree_param_specs", "guard_tree_specs",
                            "tree_shardings"},
    "repro.configs.base": {"resolve_batch", "opt_state_specs"},
    "repro.configs.families": {"GNNArch", "MACEArch", "RecsysArch"},
}


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.mining.driver, "
        "repro_torch.mining.incremental, repro_torch.launch.mine, "
        "repro_torch.serving, repro_torch.serving.batch, "
        "repro_torch.serving.streaming, repro_torch.serving.faults, "
        "repro_torch.serving.router, repro_torch.serving.cluster, "
        "repro_torch.serving.sharded, repro_torch.mining.distributed, "
        "repro_torch.launch.mesh, repro_torch.obs, "
        "repro_torch.launch.serve, repro_torch.launch.train, "
        "repro_torch.configs.registry, repro_torch.models.convert, "
        "repro_torch.training.train_loop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[os.path.relpath(p, ROOT) for p in PORT_FILES])
def test_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def _public_names(module: str):
    """The public names a JAX package module defines at top level (its
    functions, classes and assignments) and, for a package, those its
    ``__init__`` imports from its own modules; read from the source, so
    JAX is not imported."""
    path = os.path.join(SRC, *module.split("."))
    is_pkg = os.path.isdir(path)
    path = os.path.join(path, "__init__.py") if is_pkg else path + ".py"
    names = set()
    for node in ast.parse(open(path).read(), filename=path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and is_pkg and node.level:
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("module", sorted(SURFACES))
def test_port_mirrors_public_surface(module):
    """``from <port counterpart> import X`` works for every public X of
    the JAX module but those listed in ``LATER_SLICES``, and none of
    those exists yet (the list stays exact)."""
    later = LATER_SLICES.get(module, set())
    names = _public_names(module)
    assert names, module
    assert later <= set(names), later - set(names)
    names = [n for n in names if n not in later]
    code = (
        "import importlib, sys\n"
        f"mod = importlib.import_module({SURFACES[module]!r})\n"
        f"missing = [n for n in {names!r} if not hasattr(mod, n)]\n"
        f"early = [n for n in {sorted(later)!r} if hasattr(mod, n)]\n"
        "print(missing, early)\n"
        "sys.exit(1 if missing or early else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
