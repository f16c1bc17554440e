"""Guarded-by analyzer (pass 5 of ``distkeras-torch-lint``).

The lock-order pass checks lock *ordering*; this pass checks *which state each lock
actually protects*.  Over the hub stack (``runtime/`` +
``observability/``) it:

1. discovers every **thread root** — methods handed to
   ``threading.Thread(target=...)``, callbacks registered through
   ``*.subscribe(...)``, and the nested functions those forms spawn —
   and whether each root runs as ONE thread (a daemon loop) or MANY
   (handler threads created in an accept loop, one worker thread per
   index);
2. builds a resolved call graph (the ``lock_order`` resolution rules:
   ``self.meth``, typed attribute chains, local aliases, bare in-module
   functions) and propagates **execution contexts** — which roots can be
   on the stack when each method runs (public methods and methods with
   no in-tree callers additionally run on the caller's thread,
   context ``main``);
3. collects every ``self._attr`` **write site** (plain/aug/ann
   assignments and element stores like ``self.center[i][ids] += g``)
   outside ``__init__``.  An attribute written from more than one
   context — or from any *multi* root, where N copies of the same loop
   race each other — is **shared state** and must be declared in
   :data:`~distkeras_torch.analysis.lock_manifest.GUARDED_BY`;
4. checks every write to a declared attribute happens while its
   declared guard is held — lexically (``with self._lock:``) or at
   method entry, inferred as the intersection of the held sets at every
   resolved call site (the ``*_locked`` helper convention, checked
   instead of trusted).

Findings carry rule id ``unguarded``; point suppressions use
``# lint: unguarded-ok <reason>`` with the self-cleaning grammar
(reasonless/stale annotations are findings).  The manifest itself is
self-cleaning too: a ``GUARDED_BY`` entry whose attribute is no longer
shared, whose lock node no longer exists, or whose by-design ``None``
guard lacks a reason is a finding.

Known, documented limits: container mutations through bound methods
(``self._conns.append(c)``) are not write sites (the lock-order pass's
one-level call resolution does not model ``list.append``); reads are
not tracked (the dynamic lockset checker covers read-vs-write races at
runtime); attributes only ever written before threads start are
single-context by construction.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis import lock_manifest
from distkeras_torch.analysis.core import (Finding, SourceFile,
                                           apply_annotations, load_sources,
                                           python_files, rel, repo_root)
from distkeras_torch.analysis.lock_order import (DEFAULT_SUBDIRS, ClassInfo,
                                                 LockIndex, ModuleIndex,
                                                 _attr_chain, _find_method,
                                                 _local_aliases)

RULE = "unguarded"

#: context tag for code running on the caller's (API/user) thread
MAIN = "main"

_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
               ast.DictComp, ast.GeneratorExp)


class Scope:
    """One analyzed function body: a method, module function, or nested
    ``def`` (which may be a thread target)."""

    def __init__(self, name: str, mod: ModuleIndex, cls: Optional[ClassInfo],
                 fn: ast.AST, aliases: Dict[str, Tuple[str, ...]]):
        self.name = name
        self.mod = mod
        self.cls = cls
        self.fn = fn
        self.aliases = aliases
        self.is_init = name.endswith(".__init__")
        #: (callee scope name, frozenset held at the call site, line)
        self.calls: List[Tuple[str, frozenset, int]] = []
        #: (attr, line, end_line, frozenset held lexically, element_store)
        self.writes: List[Tuple[str, int, int, frozenset, bool]] = []
        #: thread-root registrations found in this scope's body:
        #: (target scope name, multi) — multi when the registration sits
        #: inside a loop/comprehension (N concurrent copies of the root)
        self.spawns: List[Tuple[str, bool]] = []


class GuardedByIndex:
    """The whole-tree index: scopes, call graph, roots, write sites."""

    def __init__(self, sources: Dict[str, SourceFile], root: str):
        self.root = root
        self.index = LockIndex(sources)
        self.scopes: Dict[str, Scope] = {}
        #: root scope name -> multi flag (True once ANY registration is
        #: multi — a root spawned once per connection races itself)
        self.roots: Dict[str, bool] = {}
        for mod in self.index.modules.values():
            for fname, fn in mod.functions.items():
                self._add_scope(f"{mod.stem}.{fname}", mod, None, fn, {})
            for cls in mod.classes.values():
                for mname, fn in cls.methods.items():
                    self._add_scope(f"{cls.name}.{mname}", mod, cls, fn, {})
        for scope in list(self.scopes.values()):
            self._walk_scope(scope)
        self._resolve_spawns()

    # -- construction ----------------------------------------------------------

    def _add_scope(self, name: str, mod: ModuleIndex, cls: Optional[ClassInfo],
                   fn: ast.AST, outer_aliases: Dict[str, Tuple[str, ...]]):
        aliases = dict(outer_aliases)
        aliases.update(_local_aliases(fn))
        self.scopes[name] = Scope(name, mod, cls, fn, aliases)

    def _walk_scope(self, scope: Scope) -> None:
        walker = _ScopeWalker(self, scope)
        walker.walk(getattr(scope.fn, "body", []), frozenset(), in_loop=False)

    def _resolve_spawns(self) -> None:
        for scope in self.scopes.values():
            for target, multi in scope.spawns:
                if target in self.scopes:
                    self.roots[target] = self.roots.get(target, False) or multi

    # -- resolution helpers ----------------------------------------------------

    def resolve_callee(self, call: ast.Call, scope: Scope) -> Optional[str]:
        """Resolve a call expression to a scope name (lock_order rules)."""
        f = call.func
        if isinstance(f, ast.Name):
            nested = f"{scope.name}.{f.id}"
            if nested in self.scopes:
                return nested
            if f.id in scope.mod.functions:
                return f"{scope.mod.stem}.{f.id}"
            return None
        chain = _attr_chain(f)
        if chain is None:
            return None
        if chain[0] in scope.aliases:
            chain = scope.aliases[chain[0]] + chain[1:]
        if chain[0] != "self" or scope.cls is None or len(chain) < 2:
            return None
        owner: Optional[ClassInfo] = scope.cls
        for attr in chain[1:-1]:
            owner = self.index._attr_type(owner, attr)
            if owner is None:
                return None
        found = _find_method(self.index, owner, chain[-1])
        if found is None:
            return None
        _fn, defining = found
        return f"{defining.name}.{chain[-1]}"

    def resolve_target_ref(self, expr: ast.AST,
                           scope: Scope) -> Optional[str]:
        """Resolve a function REFERENCE (``target=self._loop``,
        ``subscribe(self._on_event)``, a bare nested-def name) to a scope
        name."""
        if isinstance(expr, ast.Name):
            nested = f"{scope.name}.{expr.id}"
            if nested in self.scopes:
                return nested
            if expr.id in scope.mod.functions:
                return f"{scope.mod.stem}.{expr.id}"
            return None
        chain = _attr_chain(expr)
        if chain is None or len(chain) != 2 or chain[0] != "self" \
                or scope.cls is None:
            return None
        found = _find_method(self.index, scope.cls, chain[1])
        if found is None:
            return None
        _fn, defining = found
        return f"{defining.name}.{chain[1]}"

    def defining_attr_class(self, cls: ClassInfo, attr: str) -> str:
        """The class (walking known bases) whose ``__init__`` first
        assigns ``attr`` — so subclass writes unify under one node name
        (the LOCK_ORDER naming convention).  Falls back to the writing
        class."""
        seen: Set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            init = c.methods.get("__init__")
            if init is not None and attr in _attrs_assigned(init):
                return c.name
            stack.extend(self.index.class_by_name[b] for b in c.bases
                         if b in self.index.class_by_name)
        return cls.name

    # -- analyses --------------------------------------------------------------

    def contexts(self) -> Dict[str, Set[str]]:
        """Which execution contexts (thread roots + ``main``) can be on
        the stack when each scope runs — seeded at roots, public methods
        and no-caller scopes, propagated along the call graph."""
        callers: Dict[str, List[str]] = {}
        for scope in self.scopes.values():
            for callee, _held, _line in scope.calls:
                callers.setdefault(callee, []).append(scope.name)
        ctx: Dict[str, Set[str]] = {name: set() for name in self.scopes}
        for name in self.scopes:
            short = name.rsplit(".", 1)[-1]
            if name in self.roots:
                ctx[name].add(name)
            is_public = not short.startswith("_") or short.startswith("__")
            # public methods run on the caller's thread; private scopes
            # with no resolved in-tree caller are assumed externally
            # callable too — UNLESS they are thread roots (a private
            # daemon loop's only caller is the thread that runs it)
            if (is_public or (name not in callers
                              and name not in self.roots)) \
                    and not self._is_nested(name):
                ctx[name].add(MAIN)
        changed = True
        while changed:
            changed = False
            for scope in self.scopes.values():
                for callee, _held, _line in scope.calls:
                    if callee in ctx and not ctx[scope.name] <= ctx[callee]:
                        ctx[callee] |= ctx[scope.name]
                        changed = True
        for name, c in ctx.items():
            if not c:
                c.add(MAIN)
        return ctx

    def entry_held(self) -> Dict[str, frozenset]:
        """Locks provably held at every resolved call site of each scope
        (the checked form of the ``*_locked`` convention).  Thread roots,
        no-caller scopes and public methods hold nothing at entry."""
        callers: Dict[str, List[Tuple[str, frozenset]]] = {}
        for scope in self.scopes.values():
            for callee, held, _line in scope.calls:
                callers.setdefault(callee, []).append((scope.name, held))
        held_at: Dict[str, Optional[frozenset]] = {}
        for name in self.scopes:
            short = name.rsplit(".", 1)[-1]
            is_public = not short.startswith("_") or short.startswith("__")
            if name in self.roots or name not in callers \
                    or (is_public and not self._is_nested(name)):
                held_at[name] = frozenset()
            else:
                held_at[name] = None  # ⊤ until a caller resolves
        changed = True
        while changed:
            changed = False
            for name, sites in callers.items():
                if held_at.get(name) == frozenset():
                    continue  # seeded — external callers hold nothing
                cands = [h | held_at[c] for c, h in sites
                         if held_at.get(c) is not None]
                if not cands:
                    continue
                new = frozenset.intersection(*cands)
                if held_at[name] is None or new < held_at[name]:
                    held_at[name] = new
                    changed = True
        return {n: (h if h is not None else frozenset())
                for n, h in held_at.items()}

    def _is_nested(self, name: str) -> bool:
        return name.count(".") >= 2

    def shared_attrs(self, ctx: Dict[str, Set[str]]
                     ) -> Dict[str, Dict[str, object]]:
        """``Class._attr`` -> {contexts, multi, writes} for every
        attribute written outside ``__init__`` from more than one
        context, or from any multi root."""
        return {k: v for k, v in self.written_attrs(ctx).items()
                if len(v["contexts"]) > 1 or v["multi"]}

    def written_attrs(self, ctx: Dict[str, Set[str]]
                      ) -> Dict[str, Dict[str, object]]:
        """``Class._attr`` -> {contexts, multi, writes} for every
        attribute written outside ``__init__``."""
        per_attr: Dict[str, Dict[str, object]] = {}
        for scope in self.scopes.values():
            if scope.cls is None or scope.is_init:
                continue
            for attr, line, end, held, elem in scope.writes:
                key = f"{self.defining_attr_class(scope.cls, attr)}.{attr}"
                rec = per_attr.setdefault(
                    key, {"contexts": set(), "multi": False, "writes": []})
                rec["contexts"] |= ctx.get(scope.name, {MAIN})
                rec["multi"] = rec["multi"] or any(
                    self.roots.get(r, False) for r in ctx.get(scope.name, ()))
                rec["writes"].append((scope, attr, line, end, held, elem))
        return per_attr


def _attrs_assigned(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.add(t.attr)
    return out


def _write_target_attr(target: ast.AST,
                       aliases: Dict[str, Tuple[str, ...]]
                       ) -> Optional[Tuple[str, bool]]:
    """``(attr, element_store)`` when ``target`` writes through
    ``self.attr`` — plain (``self.x = v``), tuple-unpack members, or an
    element store (``self.x[i] = v``, ``self.x[i][ids] += v``)."""
    elem = False
    node = target
    while isinstance(node, ast.Subscript):
        elem = True
        node = node.value
    # element stores may go through a deeper chain (self.center[i][...])
    chain = _attr_chain(node)
    if chain is None:
        return None
    if chain[0] in aliases and (elem or len(chain) > 1):
        # alias substitution applies when writing THROUGH the aliased
        # object (``center[i] = v`` with ``center = self.center``) — a
        # plain store to the bare local name only rebinds the local
        chain = aliases[chain[0]] + chain[1:]
    if chain[0] != "self" or len(chain) < 2:
        return None
    if len(chain) > 2 and not elem:
        return None  # self.a.b = v mutates the OTHER object; out of scope
    return chain[1], elem or len(chain) > 2


class _ScopeWalker:
    """Held-set-tracking walk of one scope body, recording calls, write
    sites and thread-root registrations; nested ``def``s become child
    scopes (their bodies run on some other stack)."""

    def __init__(self, gb: GuardedByIndex, scope: Scope):
        self.gb = gb
        self.scope = scope

    def walk(self, body: Sequence[ast.stmt], held: frozenset,
             in_loop: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child = f"{self.scope.name}.{stmt.name}"
                self.gb._add_scope(child, self.scope.mod, self.scope.cls,
                                   stmt, self.scope.aliases)
                self.gb._walk_scope(self.gb.scopes[child])
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: Set[str] = set()
                for item in stmt.items:
                    lk = self.gb.index.resolve_lock(
                        item.context_expr, self.scope.mod, self.scope.cls,
                        self.scope.aliases)
                    if lk:
                        acquired.add(lk)
                    else:
                        self._scan_exprs([item.context_expr],
                                         held | frozenset(acquired), in_loop,
                                         stmt.lineno)
                self.walk(stmt.body, held | frozenset(acquired), in_loop)
                continue
            now_loop = in_loop or isinstance(stmt, _LOOP_NODES)
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (list(stmt.targets) if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                flat: List[ast.AST] = []
                for t in targets:
                    flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List))
                                else [t])
                for t in flat:
                    hit = _write_target_attr(t, self.scope.aliases)
                    if hit is not None:
                        self.scope.writes.append(
                            (hit[0], stmt.lineno,
                             getattr(stmt, "end_lineno", 0) or 0, held,
                             hit[1]))
            self._scan_exprs(_stmt_exprs(stmt), held, now_loop, stmt.lineno)
            for sub in _stmt_bodies(stmt):
                self.walk(sub, held, now_loop)

    def _scan_exprs(self, exprs, held: frozenset, in_loop: bool,
                    line: int) -> None:
        for e in exprs:
            for node in _walk_exprs(e):
                in_loop_here = in_loop or node[1]
                call = node[0]
                if not isinstance(call, ast.Call):
                    continue
                self._maybe_spawn(call, in_loop_here)
                callee = self.gb.resolve_callee(call, self.scope)
                if callee is not None:
                    self.scope.calls.append((callee, held, call.lineno))

    def _maybe_spawn(self, call: ast.Call, in_loop: bool) -> None:
        f = call.func
        fname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if fname == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    tgt = self.gb.resolve_target_ref(kw.value, self.scope)
                    if tgt is not None:
                        self.scope.spawns.append((tgt, in_loop))
        elif fname == "subscribe" and call.args:
            tgt = self.gb.resolve_target_ref(call.args[0], self.scope)
            if tgt is not None:
                # subscription callbacks fire from whatever thread emits
                # the event — handler/ingest threads, concurrently
                self.scope.spawns.append((tgt, True))


def _stmt_exprs(stmt: ast.stmt):
    for _field, value in ast.iter_fields(stmt):
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for v in value:
                if isinstance(v, ast.expr):
                    yield v


def _stmt_bodies(stmt: ast.stmt):
    for field in ("body", "orelse", "finalbody"):
        val = getattr(stmt, field, None)
        if isinstance(val, list) and val and isinstance(val[0], ast.stmt):
            yield val
    for h in getattr(stmt, "handlers", []):
        yield h.body
    for c in getattr(stmt, "cases", []):
        yield c.body


def _walk_exprs(expr: ast.AST):
    """Yield ``(node, in_comprehension)`` pairs, skipping lambda bodies
    (deferred) but descending into comprehensions (which DO run here, in
    a loop)."""
    stack: List[Tuple[ast.AST, bool]] = [(expr, False)]
    while stack:
        node, comp = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        yield node, comp
        child_comp = comp or isinstance(node, _LOOP_NODES)
        stack.extend((c, child_comp) for c in ast.iter_child_nodes(node))


# -- the pass ------------------------------------------------------------------

def known_lock_nodes(gb: GuardedByIndex) -> Set[str]:
    out: Set[str] = set(lock_manifest.LOCK_ORDER)
    for mod in gb.index.modules.values():
        out.update(f"{mod.stem}.{n}" for n in mod.module_locks)
        for cls in mod.classes.values():
            out.update(f"{cls.name}.{a}" for a in cls.lock_attrs)
    return out


def check(sources: Dict[str, SourceFile], root: str,
          guarded_by: Optional[Dict[str, Tuple[Optional[str], str]]] = None,
          confined: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Run the guarded-by pass; ``guarded_by`` and ``confined`` default to
    the repo manifest (overridable for fixture tests: a fixture that gives
    its own ``guarded_by`` and no ``confined`` has no confined state)."""
    if confined is None:
        confined = lock_manifest.CONFINED if guarded_by is None else {}
    confined = dict(confined)
    table = dict(lock_manifest.GUARDED_BY
                 if guarded_by is None else guarded_by)
    gb = GuardedByIndex(sources, root)
    ctx = gb.contexts()
    entry = gb.entry_held()
    written = gb.written_attrs(ctx)
    shared = {k: v for k, v in written.items()
              if len(v["contexts"]) > 1 or v["multi"]}
    locks = known_lock_nodes(gb)
    findings: List[Finding] = []
    manifest_path = "distkeras_torch/analysis/lock_manifest.py"

    for key, (lock, reason) in sorted(table.items()):
        if lock is None and not str(reason).strip():
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"GUARDED_BY entry {key} declares no guard (None) and no "
                f"reason — by-design unguarded state needs a reason string"))
        if lock is not None and lock not in locks:
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"GUARDED_BY entry {key} names guard '{lock}' which is not "
                f"a known lock node (not discovered, not in LOCK_ORDER)"))
        if key not in shared:
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"stale GUARDED_BY entry: {key} is no longer written from "
                f"multiple thread roots — drop the entry (it would "
                f"pre-suppress a future genuine finding)"))

    # thread-confined state: checked for confinement at run time by the
    # lockset pass; here only for staleness and for contradiction
    for key, reason in sorted(confined.items()):
        if not str(reason).strip():
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"CONFINED entry {key} has no reason string"))
        if key not in written:
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"stale CONFINED entry: {key} has no write site outside "
                f"__init__ — drop the entry"))
        elif key in shared:
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"CONFINED entry {key} is written from multiple thread "
                f"roots ({', '.join(sorted(shared[key]['contexts']))}) — "
                f"it is shared: declare it in GUARDED_BY instead"))
        if key in table:
            findings.append(Finding(
                RULE, manifest_path, 1,
                f"{key} is in both GUARDED_BY and CONFINED — keep one"))

    for key in sorted(shared):
        rec = shared[key]
        entry_for = table.get(key)
        roots = sorted(rec["contexts"])
        if entry_for is None:
            for scope, attr, line, end, held, _elem in \
                    sorted(rec["writes"], key=lambda w: (w[0].mod.path, w[2])):
                findings.append(Finding(
                    RULE, rel(scope.mod.path, root), line,
                    f"{key} is written from multiple thread roots "
                    f"({', '.join(roots)}) but has no GUARDED_BY entry — "
                    f"declare its guard in lock_manifest.GUARDED_BY or "
                    f"annotate '# lint: unguarded-ok <reason>'",
                    end_line=end))
            continue
        lock, _reason = entry_for
        if lock is None:
            continue  # by-design unguarded, reason checked above
        for scope, attr, line, end, held, _elem in \
                sorted(rec["writes"], key=lambda w: (w[0].mod.path, w[2])):
            effective = held | entry.get(scope.name, frozenset())
            if lock not in effective:
                findings.append(Finding(
                    RULE, rel(scope.mod.path, root), line,
                    f"{key} is declared guarded by {lock} but this write "
                    f"is outside its held region (held here: "
                    f"{sorted(effective) or 'nothing'}) — take the lock or "
                    f"annotate '# lint: unguarded-ok <reason>'",
                    end_line=end))
    return apply_annotations(findings, sources, root, rule=RULE)


def dump_table(sources: Dict[str, SourceFile], root: str) -> List[str]:
    """Human-readable guarded-by discovery (``--dump-graph`` extension):
    every shared attribute, its contexts, and its declared guard."""
    gb = GuardedByIndex(sources, root)
    shared = gb.shared_attrs(gb.contexts())
    out: List[str] = []
    for key in sorted(shared):
        rec = shared[key]
        lock, reason = lock_manifest.GUARDED_BY.get(key, (None, "<undeclared>"))
        guard = lock if lock else f"UNGUARDED ({reason})"
        multi = " [multi-root]" if rec["multi"] else ""
        out.append(f"{key} <- {guard}{multi}")
        out.append(f"    contexts: {', '.join(sorted(rec['contexts']))}")
        for scope, _attr, line, _end, _held, _el in rec["writes"][:4]:
            out.append(f"    write {rel(scope.mod.path, root)}:{line} "
                       f"({scope.name})")
    return out


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    if sources is None:
        sources = load_sources(python_files(root, DEFAULT_SUBDIRS))
    return check(sources, root)
