"""Wire-action parity checker (pass 3 of ``distkeras-torch-lint``).

The PS wire protocol is implemented twice by hand: the ``ACTION_*``
registry in ``runtime/networking.py`` + the Python hub's dispatch in
``runtime/parameter_server.py``, and the char-literal dispatch in
``distkeras_torch/native/ps_server.cpp``.  These drift silently unless
checked.  This pass parses both sides (regex/char-literal scan — no
compiler needed) and fails when:

- a Python-hub-dispatched action byte is neither dispatched nor even
  referenced (reply write, explicit-refusal comment) in the C++ hub;
- the C++ dispatch handles a byte that is not a registered ``ACTION_*``
  in ``networking.py`` (an unregistered protocol extension);
- a registered ``ACTION_*`` never appears in the C++ source at all
  (a new action shipped with zero native-side story — it must at least
  be refused in a comment naming the byte, e.g. ``// 'Z' refused:``);
- a ``NotImplementedError`` guidance message anywhere in the package
  names a ``knob=value`` that is not an actual parameter of any
  function/constructor in the tree (stale advice is worse than none).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis.core import (NATIVE_DIR, Finding, SourceFile,
                                           apply_annotations, package_sources,
                                           rel, repo_root)

ACTION_DEF_RE = re.compile(r"^(ACTION_[A-Z_]+)\s*=\s*b\"(.)\"", re.M)
CPP_DISPATCH_RE = re.compile(r"action\s*==\s*'(.)'")
CPP_CHAR_RE = re.compile(r"'(.)'")
KNOB_RE = re.compile(r"\b([a-zA-Z_][a-zA-Z0-9_]*)=(?:'[^']*'|\"[^\"]*\""
                     r"|True|False|None|[0-9])")


def parse_action_registry(net_src: SourceFile) -> Dict[str, Tuple[str, int]]:
    """``networking.py``'s registry: ACTION name -> (byte char, line)."""
    out: Dict[str, Tuple[str, int]] = {}
    for m in ACTION_DEF_RE.finditer(net_src.text):
        line = net_src.text.count("\n", 0, m.start()) + 1
        out[m.group(1)] = (m.group(2), line)
    return out


def python_dispatched_actions(ps_src: SourceFile) -> Set[str]:
    """ACTION_* names compared against the dispatched action byte inside
    the Python hub's connection handler."""
    out: Set[str] = set()
    for node in ast.walk(ps_src.tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "_handle_connection":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) \
                        and sub.attr.startswith("ACTION_"):
                    out.add(sub.attr)
    return out


def cpp_action_bytes(cpp_text: str) -> Tuple[Set[str], Set[str]]:
    """(dispatched bytes, all referenced bytes) from the C++ hub source.
    "Referenced" covers dispatch arms, reply writes (``p[8] = 'V'``),
    and explicit-refusal comments naming the byte."""
    dispatched = set(CPP_DISPATCH_RE.findall(cpp_text))
    referenced = set(CPP_CHAR_RE.findall(cpp_text))
    return dispatched, referenced


def check_parity(net_src: SourceFile, ps_src: SourceFile, cpp_path: str,
                 cpp_text: str, root: str) -> List[Finding]:
    findings: List[Finding] = []
    registry = parse_action_registry(net_src)
    if not registry:
        findings.append(Finding(
            "wire-parity", rel(net_src.path, root), 1,
            "no ACTION_* registry found in networking source"))
        return findings
    byte_of = {name: b for name, (b, _) in registry.items()}
    name_of = {b: name for name, b in byte_of.items()}
    py_dispatch = python_dispatched_actions(ps_src)
    cpp_dispatch, cpp_ref = cpp_action_bytes(cpp_text)
    cpp_rel = rel(cpp_path, root)

    for name in sorted(py_dispatch):
        if name not in registry:
            continue  # a reply constant used in the handler body
        b, line = registry[name]
        if b not in cpp_ref:
            findings.append(Finding(
                "wire-parity", rel(ps_src.path, root), line,
                f"{name} (byte '{b}') is dispatched by the Python hub but "
                f"neither handled nor explicitly refused in {cpp_rel} — "
                f"add a dispatch arm or a refusal comment naming '{b}'"))
    for b in sorted(cpp_dispatch):
        if b not in name_of:
            findings.append(Finding(
                "wire-parity", cpp_rel, 1,
                f"C++ hub dispatches action byte '{b}' which is not a "
                f"registered ACTION_* in {rel(net_src.path, root)}"))
    for name, (b, line) in sorted(registry.items()):
        if b not in cpp_ref:
            findings.append(Finding(
                "wire-parity", rel(net_src.path, root), line,
                f"{name} (byte '{b}') never appears in {cpp_rel}: the "
                f"native hub must handle it, produce it, or refuse it in "
                f"a comment naming the byte"))
    return findings


def known_parameter_names(sources: Sequence[SourceFile]) -> Set[str]:
    """Every function/method parameter name defined in ``sources`` —
    the vocabulary a NotImplementedError message may recommend."""
    out: Set[str] = set()
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                for arg in (list(a.posonlyargs) + list(a.args)
                            + list(a.kwonlyargs)):
                    out.add(arg.arg)
                if a.vararg:
                    out.add(a.vararg.arg)
                if a.kwarg:
                    out.add(a.kwarg.arg)
    return out


def check_nie_knobs(sources: Dict[str, SourceFile], root: str,
                    known: Optional[Set[str]] = None) -> List[Finding]:
    """Cross-check every NotImplementedError guidance message: each
    ``knob=value`` token it names must be a real parameter somewhere in
    the analyzed tree."""
    if known is None:
        known = known_parameter_names(list(sources.values()))
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            exc = node.exc
            if not (isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name)
                    and exc.func.id == "NotImplementedError" and exc.args):
                continue
            msg = _const_str(exc.args[0])
            if msg is None:
                continue
            for knob in KNOB_RE.findall(msg):
                if knob not in known:
                    findings.append(Finding(
                        "wire-parity", rel(path, root), node.lineno,
                        f"NotImplementedError guidance names knob "
                        f"'{knob}=' which is not a parameter of any "
                        f"function in the tree — stale advice"))
    return findings


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _const_str(node.left), _const_str(node.right)
        if left is not None and right is not None:
            return left + right
    if isinstance(node, ast.JoinedStr):
        parts = [v.value for v in node.values
                 if isinstance(v, ast.Constant) and isinstance(v.value, str)]
        return "".join(parts)
    return None


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    if sources is None:
        sources = package_sources(root)
    net_path = os.path.join(root, "distkeras_torch", "runtime", "networking.py")
    ps_path = os.path.join(root, "distkeras_torch", "runtime",
                           "parameter_server.py")
    cpp_path = os.path.join(root, NATIVE_DIR, "ps_server.cpp")
    findings: List[Finding] = []
    # partial checkouts (``--root`` elsewhere) skip the parity legs whose
    # inputs are absent — the repo's own completeness is pinned by
    # tests/test_torch_analysis.py, which runs against the real tree
    if all(os.path.exists(p) for p in (net_path, ps_path, cpp_path)):
        net_src = sources.get(net_path) or SourceFile(net_path)
        ps_src = sources.get(ps_path) or SourceFile(ps_path)
        with open(cpp_path, encoding="utf-8") as f:
            cpp_text = f.read()
        findings.extend(check_parity(net_src, ps_src, cpp_path, cpp_text,
                                     root))
    findings.extend(check_nie_knobs(sources, root))
    # the annotation grammar covers the Python-side findings (registry
    # lines, NotImplementedError sites); C++-anchored findings pass
    # through — refusals are expressed IN the C++ source as comments
    return apply_annotations(findings, sources, root, rule="wire-parity")
