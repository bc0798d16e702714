"""JAX, its libraries and the JAX package stay out of every measured
process.  Module names are compared by their top-level name whole: the
port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import pathlib

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sedef_tpu"})


def forbidden_modules(modules) -> list[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


def imported_names(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a Python file imports."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out
