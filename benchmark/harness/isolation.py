"""No module of JAX or of the JAX package may run in the benchmark.

Names are compared by their top-level part (before the first dot) whole:
``nanopolish_tpu_torch`` is the port and passes, ``nanopolish_tpu`` is the
JAX package and fails.  The plain reference may not import the port
either."""

from __future__ import annotations

import ast
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "nanopolish_tpu")
PORT = "nanopolish_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if top(m) in FORBIDDEN})


def imports_of(source: str) -> List[str]:
    """Top-level names of every module a Python source imports (absolute
    imports; relative ones stay in the benchmark)."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [top(a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.append(top(node.module))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                in ("import_module",) and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.append(top(str(node.args[0].value)))
    return out


def violations(path: str, in_reference: bool) -> List[str]:
    with open(path) as fh:
        names = imports_of(fh.read())
    bad = [n for n in names if n in FORBIDDEN]
    if in_reference:
        bad += [n for n in names if n == PORT]
    return bad
