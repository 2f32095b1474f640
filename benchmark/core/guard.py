"""The import boundary of the benchmark.

- Nothing in the process that prints the result may hold ``jax``,
  ``jaxlib``, ``flax`` or the JAX package ``astroburst_tpu``: top-level
  module names are compared whole (``astroburst_tpu_torch`` is the
  port, not the JAX package).
- The plain reference (``benchmark/reference/``) imports nothing of the
  program either: an AST scan of its sources.
"""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "astroburst_tpu"})
REFERENCE_FORBIDDEN = FORBIDDEN | {"astroburst_tpu_torch"}


def loaded_forbidden(modules=None) -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def imported_names(source: str) -> set:
    """Top-level module names that ``source`` imports."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module.split(".")[0])
    return names


def reference_violations(ref_dir: str) -> list:
    """(file, module) pairs of imports in the reference that reach the
    program or JAX."""
    bad = []
    for name in sorted(os.listdir(ref_dir)):
        if name.endswith(".py"):
            with open(os.path.join(ref_dir, name)) as f:
                for mod in sorted(imported_names(f.read())
                                  & REFERENCE_FORBIDDEN):
                    bad.append((name, mod))
    return bad
