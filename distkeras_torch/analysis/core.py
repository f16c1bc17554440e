"""Shared infrastructure for the ``distkeras-torch-lint`` passes.

Every pass produces :class:`Finding` records over repo files and honors
the one suppression grammar::

    # lint: <rule>-ok <reason>

placed on the flagged line.  The reason is MANDATORY — an annotation
without one is itself a finding, so the tree can never accumulate
unexplained suppressions (the "no blanket suppressions" contract).
Structural exceptions that are not tied to one source line (lock-order
edges, whole locks whose purpose is I/O serialization) live
in :mod:`distkeras_torch.analysis.lock_manifest` instead, each with a
named reason string.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: rule ids (the annotation grammar's ``<rule>`` vocabulary).  Mostly one
#: per pass; the guarded-by pass owns rule ``unguarded`` (the annotation
#: reads ``# lint: unguarded-ok <reason>``) and ``protocol`` belongs to
#: the model checker.  The DYNAMIC lockset pass is deliberately absent:
#: its findings are runtime observations with no stable source anchor to
#: annotate — fix the race or declare the attribute in GUARDED_BY — so a
#: ``# lint: lockset-ok`` comment would be inert, and the hygiene sweep
#: flags it as an unknown rule instead of letting it accumulate.
RULES = ("lock-order", "blocking", "wire-parity", "telemetry",
         "unused-import", "unguarded", "protocol")

#: anchored to the START of a comment token, so prose that merely
#: mentions the grammar ("suppress with '# lint: ...'") never registers
#: as a live suppression
ANNOTATION_RE = re.compile(r"^#[ \t]*lint:\s*([a-z][a-z-]*)-ok\b[ \t]*(.*?)\s*$")


@dataclass(frozen=True)
class Finding:
    """One static-analysis violation, pinned to a file and line.
    ``end_line`` (when > line) is the flagged construct's last line —
    an annotation anywhere in [line, end_line] suppresses, so the
    natural end-of-statement placement works on multi-line calls."""

    rule: str
    path: str  # repo-relative
    line: int
    message: str
    end_line: int = 0

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


#: the port's package set: the package plus the root scripts that drive it
#: on the card (they play the part ``bench.py`` plays for the JAX package)
PACKAGE = "distkeras_torch"
PACKAGE_EXTRAS = ("chip_smoke.py", "chip_async_ab.py")

#: the port's own C++ sources (the hub, the loader, the TSAN harness)
NATIVE_DIR = os.path.join(PACKAGE, "native")


def repo_root() -> str:
    """The checkout root this package lives in (two levels above
    ``distkeras_torch/analysis/``)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def rel(path: str, root: str) -> str:
    try:
        return os.path.relpath(path, root)
    except ValueError:  # pragma: no cover - windows drive mismatch
        return path


class SourceFile:
    """One parsed Python source: text, lines, AST, and its ``# lint:``
    annotations keyed by line number."""

    def __init__(self, path: str, text: Optional[str] = None):
        self.path = path
        if text is None:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        #: line -> (rule, reason); reason may be "" (which is a finding).
        #: Parsed from REAL comment tokens — a docstring that merely
        #: mentions the grammar must not register as a suppression.
        self.annotations: Dict[int, Tuple[str, str]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    m = ANNOTATION_RE.match(tok.string)
                    if m:
                        self.annotations[tok.start[0]] = (m.group(1),
                                                          m.group(2))
        except tokenize.TokenError:  # pragma: no cover - ast.parse gates
            pass


def apply_annotations(findings: Sequence[Finding], sources: Dict[str, SourceFile],
                      root: str, rule: Optional[str] = None) -> List[Finding]:
    """Filter ``findings`` through the per-line annotation grammar.

    A finding on an annotated line whose rule matches is suppressed IFF
    the annotation carries a non-empty reason; an empty reason is a
    finding of its own.  With ``rule`` given (the calling pass's id),
    the sweep is finding-independent: EVERY annotation of that rule in
    ``sources`` is examined — a reasonless one is always reported, and
    one that no longer suppresses anything is reported as stale (the
    ruff unused-``noqa`` discipline), so suppressions can never silently
    accumulate after the code they excused is refactored away.
    """
    out: List[Finding] = []
    by_path = {rel(p, root): s for p, s in sources.items()}
    suppressed_at = set()
    for f in findings:
        src = by_path.get(f.path)
        ann_line = None
        if src is not None:
            last = max(f.line, f.end_line)
            for ln in range(f.line, last + 1):
                ann = src.annotations.get(ln)
                if ann is not None and ann[0] == f.rule:
                    ann_line = ln
                    break
        if ann_line is not None:
            suppressed_at.add((f.path, ann_line))
            continue  # reasonless annotations are reported in the sweep
        out.append(f)
    if rule is not None:
        for path, src in sorted(by_path.items()):
            for line, (arule, reason) in sorted(src.annotations.items()):
                if arule != rule:
                    continue
                if not reason:
                    out.append(Finding(rule, path, line,
                                       "suppression annotation requires a "
                                       "reason: '# lint: %s-ok <reason>'"
                                       % rule))
                elif (path, line) not in suppressed_at:
                    out.append(Finding(rule, path, line,
                                       f"stale suppression: this line no "
                                       f"longer triggers a {rule} finding — "
                                       f"drop the '# lint: {rule}-ok' "
                                       f"annotation"))
    return out


def python_files(root: str, subdirs: Sequence[str] = (PACKAGE,),
                 extra: Sequence[str] = ()) -> List[str]:
    """All ``.py`` files under ``root``'s ``subdirs`` (recursive, sorted,
    ``__pycache__`` skipped) plus any ``extra`` root-relative files that
    exist."""
    out: List[str] = []
    for sub in subdirs:
        top = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                       if f.endswith(".py"))
    for name in extra:
        p = os.path.join(root, name)
        if os.path.exists(p):
            out.append(p)
    return out


def load_sources(paths: Sequence[str]) -> Dict[str, SourceFile]:
    return {p: SourceFile(p) for p in paths}


def package_sources(root: str) -> Dict[str, SourceFile]:
    """The package set, parsed: ``distkeras_torch/`` and the root scripts."""
    return load_sources(python_files(root, (PACKAGE,), extra=PACKAGE_EXTRAS))
