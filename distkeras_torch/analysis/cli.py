"""``distkeras-torch-lint`` — run the project-aware static-analysis suite.

Usage::

    distkeras-torch-lint [--root DIR] [--json] [--pass NAME ...] [--dump-graph]
                   [--baseline FILE] [--write-baseline]

Exit code 0 when the tree is clean, 1 when any pass has findings (and 2
on usage errors).  ``--json`` emits a machine-readable report; the
default output groups findings by pass.  ``--dump-graph`` prints the
discovered lock-acquisition graph AND the guarded-by table (the inputs
to the lock-order and guarded-by checks) — the tool to run when
extending ``lock_manifest``.

``--baseline FILE`` compares findings against a recorded snapshot:
baselined findings are reported as suppressed (not failures), so a new
pass can land incrementally without a flag-day cleanup; entries the
tree no longer produces are listed as stale so the baseline shrinks to
nothing over time.  ``--write-baseline`` (with ``--baseline FILE``)
records the current findings as the new snapshot.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from distkeras_torch.analysis import (blocking, guarded_by, lock_order,
                                      lockset, protocol_model, telemetry,
                                      unused_imports, wire_parity)
from distkeras_torch.analysis.core import (RULES, Finding, load_sources,
                                           package_sources, python_files,
                                           repo_root)

#: the ONE pass table: pass name -> the rule ids it emits.  Mostly pass
#: name == rule id; the guarded-by pass emits rule ``unguarded`` (the
#: annotation grammar), and ``lockset`` is inert unless ``DKT_LOCKSET=1``
#: (dynamic checking is opt-in — the static passes carry the always-on
#: gate).  ``PASSES`` and the baseline staleness logic both derive from
#: this table, and the assert below pins it to ``core.RULES`` so the
#: annotation vocabulary and the CLI can never drift apart (``lockset``
#: is DELIBERATELY absent from RULES — see core.py).
PASS_RULES: Dict[str, Tuple[str, ...]] = {
    "lock-order": ("lock-order",),
    "blocking": ("blocking",),
    "wire-parity": ("wire-parity",),
    "telemetry": ("telemetry",),
    "unused-import": ("unused-import",),
    "guarded-by": ("unguarded",),
    "lockset": ("lockset",),
    "protocol": ("protocol",),
}
PASSES = tuple(PASS_RULES)
assert {r for rs in PASS_RULES.values() for r in rs} - {"lockset"} \
    == set(RULES), "PASS_RULES and core.RULES drifted apart"


def run_all(root: Optional[str] = None,
            passes: Optional[Sequence[str]] = None
            ) -> Dict[str, List[Finding]]:
    """Run the requested passes (default: all), parsing each source file
    exactly once — the hub subset (lock/guarded-by/protocol passes)
    aliases into the full package set, so the gate's cost is one parse
    of the tree."""
    root = root or repo_root()
    names = list(passes) if passes else list(PASSES)
    pkg_sources = hub_sources = None
    if any(n in names for n in ("wire-parity", "telemetry", "lock-order",
                                "blocking", "guarded-by", "protocol")):
        pkg_sources = package_sources(root)
        hub_paths = set(python_files(root, lock_order.DEFAULT_SUBDIRS))
        hub_sources = {p: s for p, s in pkg_sources.items()
                       if p in hub_paths}
    runners = {
        "lock-order": lambda: lock_order.run(root, hub_sources),
        "blocking": lambda: blocking.run(root, hub_sources),
        "wire-parity": lambda: wire_parity.run(root, pkg_sources),
        "telemetry": lambda: telemetry.run(root, pkg_sources),
        # package files reuse the shared parse; tests/ etc. parse here
        "unused-import": lambda: unused_imports.run(root, pkg_sources),
        "guarded-by": lambda: guarded_by.run(root, hub_sources),
        "lockset": lambda: lockset.run(root),
        "protocol": lambda: protocol_model.run(root, hub_sources),
    }
    return {name: runners[name]() for name in names}


# -- baseline snapshots --------------------------------------------------------

def _finding_key(f: Finding) -> Tuple[str, str, str]:
    """Baseline identity: rule + path + message (no line numbers — they
    shift under unrelated edits; the message pins the construct)."""
    return (f.rule, f.path, f.message)


def write_baseline(path: str, results: Dict[str, List[Finding]],
                   preserved: Sequence[Tuple[str, str, str]] = ()) -> int:
    """Record the run's findings (duplicates kept — suppression is
    multiplicity-aware) plus ``preserved`` entries carried over from
    passes this run did not execute."""
    keys = [_finding_key(f) for fs in results.values() for f in fs]
    keys.extend(tuple(e) for e in preserved)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1,
                   "findings": [{"rule": r, "path": p, "message": m}
                                for r, p, m in sorted(keys)]},
                  fh, indent=2)
        fh.write("\n")
    return len(keys) - len(preserved)


def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return [(e["rule"], e["path"], e["message"])
            for e in data.get("findings", [])]


def apply_baseline(results: Dict[str, List[Finding]],
                   baseline: Sequence[Tuple[str, str, str]]
                   ) -> Tuple[Dict[str, List[Finding]], int,
                              List[Tuple[str, str, str]]]:
    """Split results into (new findings, suppressed count, stale
    baseline entries).  Suppression is MULTIPLICITY-aware: a baseline
    recorded with N identical (rule, path, message) entries suppresses
    at most N live findings — an (N+1)th occurrence (a brand-new
    violation whose message happens to match, e.g. a second unguarded
    write of the same attribute) still fails.  Entries are only
    reported stale when the pass that emits their rule actually ran
    this invocation — ``--pass`` subsets must not advise deleting live
    suppressions."""
    from collections import Counter

    allowed = Counter(baseline)
    out: Dict[str, List[Finding]] = {}
    suppressed = 0
    for name, fs in results.items():
        kept = []
        for f in fs:
            k = _finding_key(f)
            if allowed.get(k, 0) > 0:
                allowed[k] -= 1
                suppressed += 1
            else:
                kept.append(f)
        out[name] = kept
    ran_rules = {r for name in results for r in PASS_RULES.get(name, ())
                 # the lockset pass is INERT without DKT_LOCKSET=1 — it
                 # "ran" but checked nothing, so its baseline entries
                 # must not read as stale on a plain invocation
                 if name != "lockset" or lockset.enabled()}
    stale = sorted(k for k, n in allowed.items()
                   if n > 0 and k[0] in ran_rules)
    return out, suppressed, stale


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="distkeras-torch-lint",
        description="project-aware static analysis: lock order, blocking "
                    "calls under locks, guarded-by manifest, "
                    "Python<->C++ wire-action parity, protocol model "
                    "check, telemetry-name registry, unused imports "
                    "(+ the DKT_LOCKSET=1 dynamic lockset stress)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: the checkout this "
                             "package lives in)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable findings report")
    parser.add_argument("--pass", action="append", dest="passes",
                        choices=list(PASSES), default=None,
                        help="run only this pass (repeatable)")
    parser.add_argument("--dump-graph", action="store_true",
                        help="print the discovered lock-acquisition graph "
                             "and the guarded-by table, then exit")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="suppress findings recorded in FILE (land "
                             "new passes incrementally); stale entries "
                             "are reported so the baseline burns down")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record the current findings into --baseline "
                             "FILE and exit 0")
    args = parser.parse_args(argv)
    root = args.root or repo_root()
    if args.write_baseline and not args.baseline:
        parser.error("--write-baseline requires --baseline FILE")

    if args.dump_graph:
        sources = load_sources(
            python_files(root, lock_order.DEFAULT_SUBDIRS))
        edges = lock_order.build_graph(sources, root)
        for (src, dst), locs in sorted(edges.items()):
            print(f"{src} -> {dst}")
            for path, line, via in locs[:4]:
                print(f"    {path}:{line} ({via})")
        print()
        print("guarded-by table (shared attributes and their guards):")
        for line in guarded_by.dump_table(sources, root):
            print(line)
        return 0

    t0 = time.perf_counter()
    results = run_all(root, args.passes)
    elapsed = time.perf_counter() - t0

    if args.baseline and args.write_baseline:
        preserved: List[Tuple[str, str, str]] = []
        if os.path.exists(args.baseline):
            # a --pass subset refresh must not delete the OTHER passes'
            # suppressions: keep every entry whose rule this run did not
            # re-check (same ran-rules gate apply_baseline uses,
            # including the inert-lockset case)
            ran = {r for name in results for r in PASS_RULES.get(name, ())
                   if name != "lockset" or lockset.enabled()}
            try:
                preserved = [e for e in load_baseline(args.baseline)
                             if e[0] not in ran]
            except (OSError, ValueError, KeyError, TypeError) as e:
                parser.error(f"cannot read existing baseline "
                             f"{args.baseline}: {e}")
        n = write_baseline(args.baseline, results, preserved=preserved)
        print(f"distkeras-torch-lint: wrote {n} finding(s) to baseline "
              f"{args.baseline}"
              + (f" (+{len(preserved)} preserved from passes not run)"
                 if preserved else ""))
        return 0
    suppressed, stale = 0, []
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError, TypeError) as e:
            # a missing/torn snapshot is a usage error (exit 2), not a
            # findings failure CI would misread as lint regressions
            parser.error(f"cannot read baseline {args.baseline}: {e}")
        results, suppressed, stale = apply_baseline(results, baseline)
    total = sum(len(v) for v in results.values())

    if args.as_json:
        print(json.dumps({
            "root": root,
            "elapsed_s": round(elapsed, 3),
            "total": total,
            "suppressed_by_baseline": suppressed,
            "stale_baseline_entries": [list(s) for s in stale],
            "findings": {name: [f.to_dict() for f in fs]
                         for name, fs in results.items()},
        }, indent=2))
        return 1 if total else 0

    for name in results:
        fs = results[name]
        status = "clean" if not fs else f"{len(fs)} finding(s)"
        print(f"[{name}] {status}")
        for f in fs:
            print(f"  {f}")
    if suppressed:
        print(f"baseline: {suppressed} finding(s) suppressed by "
              f"{args.baseline}")
    for rule, path, msg in stale:
        print(f"baseline: STALE entry (no longer produced): "
              f"[{rule}] {path}: {msg}")
    print(f"distkeras-torch-lint: {total} finding(s) across "
          f"{len(results)} pass(es) in {elapsed:.2f}s")
    return 1 if total else 0


if __name__ == "__main__":  # pragma: no cover - console entry
    sys.exit(main())
