"""Unused-import (F401) pass over the port — the ONE implementation the
per-package test cells delegate to: every subpackage of
``distkeras_torch/``, its root scripts, and ``tests/test_torch_*.py``.

Runs real ``ruff`` when the container has it; otherwise an AST sweep:
imported names never referenced in the module body (``__all__`` strings
and docstring mentions count, and a ``# noqa``/``# noqa: ... F401`` on
the import line is honored — the re-export idiom
``runtime/__init__.py`` uses, which real ruff also skips).  Each file is
additionally compile-checked.
"""

from __future__ import annotations

import ast
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

from distkeras_torch.analysis.core import (PACKAGE, PACKAGE_EXTRAS, Finding,
                                           SourceFile, rel, repo_root)

#: the sweep's package vocabulary — one cell a subpackage, ``.`` the
#: package's top level, ``tests`` the port's test files and ``scripts``
#: the root scripts, so scoping can never silently drop a tree
PACKAGES = ("observability", "runtime", ".", "tests", "data", "parallel",
            "models", "ops", "examples", "scripts", "analysis")

_NOQA_RE = re.compile(r"#\s*noqa(?!:)|#\s*noqa:[^#]*\bF401\b")


def unused_imports(path: str, source: Optional[str] = None,
                   tree: Optional[ast.AST] = None) -> Dict[str, int]:
    """name -> line of imports never referenced in the module body."""
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    if tree is None:
        tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    imported: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) \
                and _NOQA_RE.search(lines[node.lineno - 1]):
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                imported[(a.asname or a.name).split(".")[0]] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue  # compiler directive, never "used"
            for a in node.names:
                if a.name != "*":
                    imported[a.asname or a.name] = node.lineno
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)  # __all__ entries / docstring mentions
    return {name: line for name, line in imported.items()
            if name not in used}


def package_files(root: str, package: str) -> List[str]:
    """The file set of one historical test cell.  Missing trees yield an
    empty set (``--root`` may point at a partial checkout); the REPO's
    coverage is pinned by the named test cells, which assert non-empty."""
    if package == "tests":
        d = os.path.join(root, "tests")
        if not os.path.isdir(d):
            return []
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.startswith("test_torch_") and f.endswith(".py")]
    if package == "scripts":
        return [p for p in (os.path.join(root, n) for n in PACKAGE_EXTRAS)
                if os.path.exists(p)]
    pkg = os.path.normpath(os.path.join(root, PACKAGE, package))
    if not os.path.isdir(pkg):
        return []
    return [os.path.join(pkg, f) for f in sorted(os.listdir(pkg))
            if f.endswith(".py")]


def check_files(paths: Sequence[str], root: str,
                sources: Optional[Dict[str, SourceFile]] = None
                ) -> List[Finding]:
    """AST F401 sweep + compile check over explicit files.  ``sources``
    (path -> already-parsed SourceFile) lets the gate reuse one parse of
    the tree across passes; files not in it are read and parsed here."""
    findings: List[Finding] = []
    for path in paths:
        cached = sources.get(path) if sources else None
        if cached is not None:
            source, tree = cached.text, cached.tree
        else:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = None
        compile(source, path, "exec")  # syntax gate, no .pyc write
        for name, line in sorted(unused_imports(path, source, tree).items(),
                                 key=lambda kv: kv[1]):
            findings.append(Finding(
                "unused-import", rel(path, root), line,
                f"'{name}' imported but unused"))
    return findings


def check_package(root: str, package: str,
                  sources: Optional[Dict[str, SourceFile]] = None
                  ) -> List[Finding]:
    """One package cell: real ruff when available, else the AST sweep.
    Returns findings (empty = clean); raises only on broken source."""
    files = package_files(root, package)
    if not files:
        return []  # partial checkout; repo coverage pinned by the cells
    ruff = shutil.which("ruff")
    if ruff:
        proc = subprocess.run([ruff, "check"] + files, capture_output=True,
                              text=True, timeout=120)
        if proc.returncode == 0:
            return []
        return [Finding("unused-import", rel(os.path.join(root, package), root),
                        0, (proc.stdout + proc.stderr).strip())]
    return check_files(files, root, sources)


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    findings: List[Finding] = []
    for package in PACKAGES:
        findings.extend(check_package(root, package, sources))
    return findings
