"""Telemetry-name registry pass (pass 4 of ``distkeras-torch-lint``).

Collects metric/span name string literals from Python AND C++ sources and
fails on any name absent from :data:`~distkeras_torch.analysis.
telemetry_registry.TELEMETRY_NAMES`.  Two collectors:

- **call sites**: the first string argument of every
  ``counter``/``gauge``/``histogram``/``span``/``start_span``/
  ``record_span`` call in the package (and ``chip_smoke.py``,
  ``chip_async_ab.py``) — covers every
  direct emission regardless of namespace;
- **namespace sweep**: every string literal shaped like a project
  telemetry name (``ps_*``, ``ps.*``, ``worker.*``, ``health.*``) in the
  package and in ``distkeras_torch/native/*.cpp`` — covers indirect tables such as
  ``runtime/native.py``'s stat-key -> registry-name map and any names a
  future C++ hub emits directly.

Suppress a deliberately-out-of-registry literal (e.g. a fixture in a
docstring) with ``# lint: telemetry-ok <reason>`` on its line.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from distkeras_torch.analysis.core import (NATIVE_DIR, RULES, Finding,
                                           SourceFile, apply_annotations,
                                           package_sources, rel, repo_root)
from distkeras_torch.analysis.telemetry_registry import TELEMETRY_NAMES

#: rules whose passes honor ``# lint: <rule>-ok`` annotations — the
#: unused-import sweep uses the standard ``# noqa`` instead, so an
#: ``unused-import-ok`` annotation is as inert as a typo'd rule id
OWNED_RULES = frozenset(RULES) - {"unused-import"}

_EMITTERS = {"counter", "gauge", "histogram", "span", "start_span",
             "record_span"}

#: full-match shape of a project telemetry name
NAMESPACE_RE = re.compile(
    r"^(?:ps_[a-z0-9_]+|ps\.[a-z0-9_]+|worker\.[a-z0-9_]+"
    r"|health\.[a-z0-9_]+)$")

#: the same shape, as a scan over C++ string literals
_CPP_LITERAL_RE = re.compile(
    r"\"((?:ps_[a-z0-9_]+|ps\.[a-z0-9_]+|worker\.[a-z0-9_]+"
    r"|health\.[a-z0-9_]+))\"")


def collect_python(src: SourceFile) -> List[Tuple[str, int, str]]:
    """(name, line, how) literals from one Python source."""
    out: List[Tuple[str, int, str]] = []
    seen_call_sites = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            fname = None
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            if fname in _EMITTERS and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    out.append((arg.value, arg.lineno, f"{fname}() call"))
                    seen_call_sites.add(id(arg))
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in seen_call_sites \
                and NAMESPACE_RE.match(node.value):
            out.append((node.value, node.lineno, "namespace literal"))
    return out


def collect_cpp(text: str) -> List[Tuple[str, int, str]]:
    out: List[Tuple[str, int, str]] = []
    for i, line in enumerate(text.splitlines(), start=1):
        for m in _CPP_LITERAL_RE.finditer(line):
            out.append((m.group(1), i, "C++ literal"))
    return out


def check(sources: Dict[str, SourceFile], cpp_files: Dict[str, str],
          root: str,
          registry: Optional[Set[str]] = None) -> List[Finding]:
    registry = TELEMETRY_NAMES if registry is None else set(registry)
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        for name, line, how in collect_python(src):
            if _is_telemetry_shaped(name, how) and name not in registry:
                findings.append(_finding(path, line, name, how, root))
    for path, text in sorted(cpp_files.items()):
        for name, line, how in collect_cpp(text):
            if name not in registry:
                findings.append(_finding(path, line, name, how, root))
    # annotation-rule hygiene rides THIS pass because it scans the widest
    # Python source set: an annotation with a typo'd or unowned rule id
    # ("# lint: telemtry-ok ...", "# lint: unused-import-ok ...") would
    # otherwise be silently inert — never honored, never reported
    for path, src in sorted(sources.items()):
        for line, (arule, _reason) in sorted(src.annotations.items()):
            if arule not in OWNED_RULES:
                findings.append(Finding(
                    "telemetry", rel(path, root), line,
                    f"annotation names unknown lint rule '{arule}' — "
                    f"no pass honors '# lint: {arule}-ok' (valid rules: "
                    f"{', '.join(sorted(OWNED_RULES))}; unused imports "
                    f"use '# noqa: F401')"))
    return apply_annotations(findings, sources, root, rule="telemetry")


def _is_telemetry_shaped(name: str, how: str) -> bool:
    """Call-site first-args are always telemetry names; bare literals
    only count when they match the project namespace shape."""
    if how.endswith("call"):
        # metric/span constructors take ONLY telemetry names first; any
        # shape is checked so a typo in an un-namespaced name
        # (``trainer_epoc_seconds``) is caught too
        return bool(re.match(r"^[a-z][a-z0-9_.]+$", name))
    return bool(NAMESPACE_RE.match(name))


def _finding(path: str, line: int, name: str, how: str,
             root: str) -> Finding:
    return Finding(
        "telemetry", rel(path, root), line,
        f"telemetry name \"{name}\" ({how}) is not in "
        f"analysis/telemetry_registry.py — a typo here is a silently "
        f"missing series; register the name or fix the literal")


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    if sources is None:
        sources = package_sources(root)
    cpp_files: Dict[str, str] = {}
    for path in sorted(glob.glob(os.path.join(root, NATIVE_DIR, "*.cpp"))):
        with open(path, encoding="utf-8") as f:
            cpp_files[path] = f.read()
    return check(sources, cpp_files, root)
