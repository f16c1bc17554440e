"""Blocking-call-under-lock detector (pass 2 of ``distkeras-torch-lint``).

Flags calls that can park a thread — socket sends/receives (anything
``send*``/``recv*``, including the repo's framed-transport wrappers),
``time.sleep``, zero-arg ``.join()`` (``Thread.join``; one-arg joins are
``str.join``), ``subprocess.*``, ``.result()``, ``accept``/``connect`` —
lexically inside a held-lock region.  This is the heartbeat bug
shape (the ping held the client io lock into a 60 s data-plane timeout),
caught at parse time instead of in a distributed-timeout postmortem.

Two suppression mechanisms, both with mandatory reasons:

- ``# lint: blocking-ok <reason>`` on the flagged line (point sites
  where the blocking call IS the design, e.g. the replication feed's
  send-before-ack contract);
- ``lock_manifest.IO_LOCKS`` for locks whose declared purpose is
  serializing blocking I/O (the PSClient io lock): a region is skipped
  only when EVERY held lock is so declared — holding a state lock
  alongside an io lock still flags.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from distkeras_torch.analysis import lock_manifest
from distkeras_torch.analysis.core import (Finding, SourceFile,
                                           apply_annotations, load_sources,
                                           python_files, rel, repo_root)
from distkeras_torch.analysis.lock_order import (DEFAULT_SUBDIRS, LockIndex,
                                                 _local_aliases, _own_exprs,
                                                 _sub_bodies,
                                                 _walk_outside_lambda)

_BLOCKING_ATTR_EXACT = {"sleep", "result", "accept", "connect",
                        "create_connection", "getaddrinfo"}
_BLOCKING_NAME_EXACT = {"sleep", "connect", "create_connection"}
_SUBPROCESS_BASES = {"subprocess"}


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call counts as blocking, or None."""
    f = call.func
    if isinstance(f, ast.Attribute):
        attr = f.attr
        base = f.value
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name) and base.id in _SUBPROCESS_BASES:
            return f"subprocess.{attr}"
        if attr.startswith("send") or attr.startswith("recv"):
            return f".{attr}() does socket I/O"
        if attr in _BLOCKING_ATTR_EXACT:
            return f".{attr}() blocks"
        if attr == "join" and not call.args and not call.keywords:
            return ".join() on a thread blocks"
        if attr == "join" and call.keywords \
                and all(k.arg == "timeout" for k in call.keywords) \
                and not call.args:
            return ".join(timeout=...) on a thread blocks"
        return None
    if isinstance(f, ast.Name):
        name = f.id
        if name.startswith("send") or name.startswith("recv"):
            return f"{name}() does socket I/O"
        if name in _BLOCKING_NAME_EXACT:
            return f"{name}() blocks"
    return None


class _Scanner:
    def __init__(self, index: LockIndex, mod, cls, root: str,
                 io_locks: Dict[str, str]):
        self.index = index
        self.mod = mod
        self.cls = cls
        self.root = root
        self.io_locks = io_locks
        self.findings: List[Finding] = []

    def run(self, fn: ast.AST) -> None:
        self.aliases = _local_aliases(fn)
        self._walk(getattr(fn, "body", []), [])

    def _walk(self, body: Sequence[ast.stmt], held: List[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in stmt.items:
                    lk = self.index.resolve_lock(item.context_expr, self.mod,
                                                 self.cls, self.aliases)
                    if lk:
                        acquired.append(lk)
                    else:
                        # a non-lock context expression evaluated while
                        # earlier items/locks are held may itself block
                        # (``with lock: with sock.accept() as c:``)
                        self._flag_exprs([item.context_expr],
                                         held + acquired)
                self._walk(stmt.body, held + acquired)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(stmt.body, [])  # runs later, not under held
            else:
                # only this statement's OWN expressions: nested statement
                # bodies are walked separately (with any locks THEY add)
                self._flag_exprs(_own_exprs(stmt), held)
                for sub in _sub_bodies(stmt):
                    self._walk(sub, held)

    def _flag_exprs(self, exprs, held: List[str]) -> None:
        culprits = [h for h in held if h not in self.io_locks]
        if not culprits:
            return
        for node in (n for e in exprs for n in _walk_outside_lambda(e)):
            if not isinstance(node, ast.Call):
                continue
            why = _blocking_reason(node)
            if why is None:
                continue
            self.findings.append(Finding(
                "blocking", rel(self.mod.path, self.root), node.lineno,
                f"{why} while holding {', '.join(culprits)} — annotate "
                f"'# lint: blocking-ok <reason>' if the stall is bounded "
                f"by design",
                end_line=getattr(node, "end_lineno", 0) or 0))


def check(sources: Dict[str, SourceFile], root: str,
          io_locks: Optional[Dict[str, str]] = None) -> List[Finding]:
    io_locks = dict(lock_manifest.IO_LOCKS if io_locks is None else io_locks)
    findings: List[Finding] = []
    for node, reason in io_locks.items():
        if not str(reason).strip():
            findings.append(Finding(
                "blocking", "distkeras_torch/analysis/lock_manifest.py", 1,
                f"IO_LOCKS entry {node} has no reason string"))
    index = LockIndex(sources)
    for mod in index.modules.values():
        scopes = [(None, fn) for fn in mod.functions.values()]
        for cls in mod.classes.values():
            scopes.extend((cls, fn) for fn in cls.methods.values())
        for cls, fn in scopes:
            s = _Scanner(index, mod, cls, root, io_locks)
            s.run(fn)
            findings.extend(s.findings)
    return apply_annotations(findings, sources, root, rule="blocking")


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    if sources is None:
        sources = load_sources(python_files(root, DEFAULT_SUBDIRS))
    return check(sources, root)
