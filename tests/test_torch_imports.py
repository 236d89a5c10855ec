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
    ("torch_dist_worker.py", "test_torch_distributed_cuda.py")]
# JAX package module -> the port's counterpart, held name for name
SURFACES = {
    "repro.serving": "repro_torch.serving",
    "repro.obs": "repro_torch.obs",
    "repro.mining.engine": "repro_torch.mining.engine",
    "repro.mining.distributed": "repro_torch.mining.distributed",
    "repro.serving.sharded": "repro_torch.serving.sharded",
    "repro.launch.mesh": "repro_torch.launch.mesh",
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
        "repro_torch.launch.serve\n"
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
    the JAX module, none excused."""
    names = _public_names(module)
    assert names, module
    code = (
        "import importlib, sys\n"
        f"mod = importlib.import_module({SURFACES[module]!r})\n"
        f"missing = [n for n in {names!r} if not hasattr(mod, n)]\n"
        "print(missing)\n"
        "sys.exit(1 if missing else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
