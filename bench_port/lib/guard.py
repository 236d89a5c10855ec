"""The import guard.  The benchmark runs the PyTorch port and nothing of
JAX or of the JAX package ``repro``; names are compared whole by their
top-level part, since the port's own name, ``repro_torch``, begins with
``repro``.

* ``loaded_forbidden()``: the forbidden top-level modules in
  ``sys.modules``; ``run.py`` refuses to print a result when there is one.
* ``scan_imports(path)``: the top-level names a Python file imports (an
  AST scan; the harness's tests hold every file under ``bench_port/`` to
  ``FORBIDDEN``, and the reference also to ``PROGRAM``).
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Set

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM = "repro_torch"


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``)."""
    tops = {name.split(".", 1)[0]
            for name in list(sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def scan_imports(path: Path) -> Set[str]:
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".", 1)[0])
    return names
