"""Lock-order analyzer (pass 1 of ``distkeras-torch-lint``).

An AST pass over the hub stack (``runtime/`` + ``observability/``) that:

1. discovers every lock attribute — ``self._x = threading.Lock()`` (or
   ``RLock``/``Condition``) in any method, plus module-level locks —
   naming each node by the class that DEFINES it (``ClassName._attr``) or
   its module (``module._name``);
2. builds the acquisition graph: lock A "held into" lock B when a
   ``with B`` nests lexically inside a ``with A`` region, or when a call
   made while A is held resolves (ONE level, intra-module: ``self.meth``
   through the class and its in-module bases, bare names through
   module-level functions) to a function that acquires B.  Simple local
   aliases (``hub = self.hub``) and annotated constructor attributes
   (``self.hub = hub`` with ``hub: "SocketParameterServer"``) are
   resolved so the real cross-class edges (feed -> hub center lock) are
   seen;
3. fails on self-edges (re-acquiring a non-reentrant lock — the
   ``monitor()`` deadlock shape), on cycles, and on any edge that points
   BACKWARD against the declared :data:`~distkeras_torch.analysis.
   lock_manifest.LOCK_ORDER`; an edge lock must be listed in the
   manifest so every new nesting is an explicit ordering decision.

Documented exceptions (e.g. ``SnapshotSetCoordinator`` holding every
center lock at once) are allow-listed in ``lock_manifest.EXCEPTIONS``
with a reason string; an empty reason is itself a finding.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis import lock_manifest
from distkeras_torch.analysis.core import (Finding, SourceFile,
                                           apply_annotations, load_sources,
                                           python_files, rel, repo_root)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

Edge = Tuple[str, str]


def _is_lock_value(node: ast.AST) -> bool:
    """True if the assigned value contains a ``threading.Lock()``-style
    call (covers conditional forms like ``Lock() if x else None``)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in _LOCK_FACTORIES \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "threading":
                return True
            if isinstance(f, ast.Name) and f.id in _LOCK_FACTORIES:
                return True
    return False


class ClassInfo:
    def __init__(self, name: str, module: str):
        self.name = name
        self.module = module
        #: back-reference to the defining ModuleIndex — callee lock
        #: resolution must use the module the code is DEFINED in, not
        #: the caller's (same-named module locks would cross-talk)
        self.modindex: Optional["ModuleIndex"] = None
        self.bases: List[str] = []
        self.lock_attrs: Set[str] = set()
        #: attr -> class name, from annotated ``self.attr = param``
        self.attr_class: Dict[str, str] = {}
        self.methods: Dict[str, ast.FunctionDef] = {}


class ModuleIndex:
    """Lock/class/function index of one module."""

    def __init__(self, path: str, src: SourceFile):
        self.path = path
        self.stem = os.path.splitext(os.path.basename(path))[0]
        self.src = src
        self.classes: Dict[str, ClassInfo] = {}
        self.module_locks: Set[str] = set()
        self.functions: Dict[str, ast.FunctionDef] = {}
        self._build()

    def _build(self) -> None:
        for node in self.src.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_value(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_locks.add(t.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                info = ClassInfo(node.name, self.stem)
                info.modindex = self
                info.bases = [b.id for b in node.bases
                              if isinstance(b, ast.Name)]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        info.methods[item.name] = item
                        self._scan_method(info, item)
                self.classes[node.name] = info

    def _scan_method(self, info: ClassInfo, fn: ast.FunctionDef) -> None:
        ann: Dict[str, str] = {}
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            t = a.annotation
            if isinstance(t, ast.Constant) and isinstance(t.value, str):
                ann[a.arg] = t.value.strip("'\"")
            elif isinstance(t, ast.Name):
                ann[a.arg] = t.id
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    if _is_lock_value(node.value):
                        info.lock_attrs.add(t.attr)
                    elif isinstance(node.value, ast.Name) \
                            and node.value.id in ann:
                        info.attr_class[t.attr] = ann[node.value.id]
                    elif isinstance(node.value, ast.Call):
                        # direct constructor assignment (``self._feed =
                        # ReplicationFeed(self)``): the attribute's type
                        # is the called class — resolved later against
                        # the cross-module class index, so non-class
                        # callees simply never resolve
                        f = node.value.func
                        cname = (f.id if isinstance(f, ast.Name)
                                 else f.attr if isinstance(f, ast.Attribute)
                                 else None)
                        if cname is not None and cname[:1].isupper():
                            info.attr_class.setdefault(t.attr, cname)


class LockIndex:
    """The cross-module index the lock-order and blocking passes share."""

    def __init__(self, sources: Dict[str, SourceFile]):
        self.modules: Dict[str, ModuleIndex] = {
            p: ModuleIndex(p, s) for p, s in sources.items()}
        self.class_by_name: Dict[str, ClassInfo] = {}
        for m in self.modules.values():
            for c in m.classes.values():
                self.class_by_name.setdefault(c.name, c)

    # -- resolution ------------------------------------------------------------
    def _defining_class(self, cls: ClassInfo, attr: str) -> Optional[ClassInfo]:
        seen: Set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            if attr in c.lock_attrs:
                return c
            stack.extend(self.class_by_name[b] for b in c.bases
                         if b in self.class_by_name)
        return None

    def _attr_type(self, cls: ClassInfo, attr: str) -> Optional[ClassInfo]:
        seen: Set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            if attr in c.attr_class:
                return self.class_by_name.get(c.attr_class[attr])
            stack.extend(self.class_by_name[b] for b in c.bases
                         if b in self.class_by_name)
        return None

    def resolve_lock(self, expr: ast.AST, mod: ModuleIndex,
                     cls: Optional[ClassInfo],
                     aliases: Dict[str, Tuple[str, ...]]) -> Optional[str]:
        """Resolve a ``with``-item (or ``.acquire()`` receiver) expression
        to a lock node name, or None for non-lock/unresolvable items."""
        chain = _attr_chain(expr)
        if chain is None:
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in aliases:
                chain = aliases[name]
            elif name in mod.module_locks:
                return f"{mod.stem}.{name}"
            else:
                return None
        elif chain[0] in aliases:
            chain = aliases[chain[0]] + chain[1:]
        if chain[0] != "self" or cls is None or len(chain) < 2:
            return None
        owner: Optional[ClassInfo] = cls
        for attr in chain[1:-1]:
            owner = self._attr_type(owner, attr)
            if owner is None:
                return None
        defining = self._defining_class(owner, chain[-1])
        if defining is None:
            return None
        return f"{defining.name}.{chain[-1]}"

    def locks_acquired_in(self, fn: ast.AST, mod: ModuleIndex,
                          cls: Optional[ClassInfo]) -> Set[str]:
        """Every lock node this function acquires anywhere in its body
        (``with`` items and bare ``.acquire()`` calls) — the one-level
        call-resolution summary.  Deferred code (lambdas, nested defs)
        is excluded: it runs later, on some other call stack."""
        out: Set[str] = set()
        aliases = _local_aliases(fn)
        for node in _walk_outside_deferred(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lk = self.resolve_lock(item.context_expr, mod, cls,
                                           aliases)
                    if lk:
                        out.add(lk)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                lk = self.resolve_lock(node.func.value, mod, cls, aliases)
                if lk:
                    out.add(lk)
        return out


def _attr_chain(expr: ast.AST) -> Optional[Tuple[str, ...]]:
    """``self.hub._lock`` -> ("self", "hub", "_lock"); None when the
    expression is not a plain name/attribute chain."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _local_aliases(fn: ast.AST) -> Dict[str, Tuple[str, ...]]:
    """First-assignment local aliases of self-attribute chains
    (``hub = self.hub`` -> {"hub": ("self", "hub")})."""
    out: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            chain = _attr_chain(node.value)
            if chain and chain[0] == "self" \
                    and node.targets[0].id not in out:
                out[node.targets[0].id] = chain
    return out


class _EdgeCollector:
    """Walks one function body tracking the held-lock stack, emitting
    acquisition edges (nested ``with`` + one-level call resolution)."""

    def __init__(self, index: LockIndex, mod: ModuleIndex,
                 cls: Optional[ClassInfo], root: str):
        self.index = index
        self.mod = mod
        self.cls = cls
        self.root = root
        self.edges: Dict[Edge, List[Tuple[str, int, str]]] = {}

    def _add(self, src: str, dst: str, line: int, via: str) -> None:
        self.edges.setdefault((src, dst), []).append(
            (rel(self.mod.path, self.root), line, via))

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
                        for h in held + acquired:
                            self._add(h, lk, stmt.lineno, "with")
                        acquired.append(lk)
                    elif held or acquired:
                        # non-lock context manager entered while held may
                        # still acquire (obs.span does not; a callable
                        # that does would need its own with-scan) — only
                        # CALL resolution below sees through it
                        self._scan_calls(item.context_expr, held + acquired,
                                         stmt.lineno)
                self._walk(stmt.body, held + acquired)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: runs later, not under the current held set
                _EdgeCollector(self.index, self.mod, self.cls,
                               self.root)._merge_into(self, stmt)
            else:
                if held:
                    self._scan_calls(stmt, held, stmt.lineno)
                for child_body in _sub_bodies(stmt):
                    self._walk(child_body, held)

    def _merge_into(self, parent: "_EdgeCollector", fn: ast.AST) -> None:
        self.run(fn)
        for edge, locs in self.edges.items():
            parent.edges.setdefault(edge, []).extend(locs)

    def _scan_calls(self, node: ast.AST, held: List[str], line: int) -> None:
        """One level of intra-module call resolution: edges from every
        held lock to every lock the (resolvable) callee acquires.  When
        handed a statement, only its OWN expressions are scanned — its
        nested statement bodies are walked separately."""
        roots = (list(_own_exprs(node)) if isinstance(node, ast.stmt)
                 else [node])
        # lambdas built while held run LATER, outside the lock — calls
        # inside them are neither blocking-under-lock nor acquisitions
        for call in (c for r in roots for c in _walk_outside_lambda(r)):
            if not isinstance(call, ast.Call):
                continue
            callee: Optional[ast.AST] = None
            callee_cls = self.cls
            callee_mod = self.mod
            f = call.func
            if isinstance(f, ast.Attribute):
                chain = _attr_chain(f)
                if f.attr == "acquire":
                    lk = self.index.resolve_lock(f.value, self.mod, self.cls,
                                                 self.aliases)
                    if lk:
                        for h in held:
                            self._add(h, lk, call.lineno, "acquire()")
                    continue
                found = None
                if chain and chain[0] == "self" and len(chain) == 2 \
                        and self.cls is not None:
                    found = _find_method(self.index, self.cls, chain[1])
                elif chain and len(chain) >= 2:
                    # method on a typed attribute chain (self.hub.promote)
                    base = chain[:-1]
                    owner = self._resolve_owner(base)
                    if owner is not None:
                        found = _find_method(self.index, owner, chain[-1])
                        callee_cls = owner
                if found is not None:
                    callee, defining = found
                    # resolve the callee's bare-name/module locks against
                    # the module its code lives in, not the caller's
                    callee_mod = defining.modindex or self.mod
            elif isinstance(f, ast.Name) and f.id in self.mod.functions:
                callee = self.mod.functions[f.id]
                callee_cls = None
            if callee is None:
                continue
            for lk in self.index.locks_acquired_in(callee, callee_mod,
                                                   callee_cls):
                for h in held:
                    self._add(h, lk, call.lineno,
                              f"call {ast.unparse(f)}()")

    def _resolve_owner(self, base: Tuple[str, ...]) -> Optional[ClassInfo]:
        if base[0] in self.aliases:
            base = self.aliases[base[0]] + base[1:]
        if base[0] != "self" or self.cls is None:
            return None
        owner: Optional[ClassInfo] = self.cls
        for attr in base[1:]:
            owner = self.index._attr_type(owner, attr)
            if owner is None:
                return None
        return owner


def _find_method(index: LockIndex, cls: ClassInfo, name: str
                 ) -> Optional[Tuple[ast.FunctionDef, ClassInfo]]:
    """Resolve ``name`` through ``cls`` and its known bases, returning
    the method AND the class that defines it (whose module scopes the
    callee's lock resolution)."""
    seen: Set[str] = set()
    stack = [cls]
    while stack:
        c = stack.pop(0)
        if c.name in seen:
            continue
        seen.add(c.name)
        if name in c.methods:
            return c.methods[name], c
        stack.extend(index.class_by_name[b] for b in c.bases
                     if b in index.class_by_name)
    return None


def _sub_bodies(stmt: ast.stmt):
    for field in ("body", "orelse", "finalbody"):
        val = getattr(stmt, field, None)
        if isinstance(val, list) and val and isinstance(val[0], ast.stmt):
            yield val
    for h in getattr(stmt, "handlers", []):
        yield h.body
    for c in getattr(stmt, "cases", []):  # match-case arms
        yield c.body


def _own_exprs(stmt: ast.stmt):
    """The expression children of one statement, EXCLUDING nested
    statement lists (those are walked separately with their own held
    sets — scanning them here would double-count)."""
    for _field, value in ast.iter_fields(stmt):
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for v in value:
                if isinstance(v, ast.expr):
                    yield v


def _walk_outside_lambda(expr: ast.AST):
    """``ast.walk`` that does not descend into ``lambda`` bodies — a
    lambda built under a lock runs LATER, outside it."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _walk_outside_deferred(fn: ast.AST):
    """Walk a function body excluding deferred code — lambdas AND nested
    function definitions (both run later, on another call stack)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def build_graph(sources: Dict[str, SourceFile],
                root: str) -> Dict[Edge, List[Tuple[str, int, str]]]:
    """The full acquisition graph over ``sources``:
    ``(holder, acquired) -> [(path, line, via), ...]``."""
    index = LockIndex(sources)
    edges: Dict[Edge, List[Tuple[str, int, str]]] = {}
    for mod in index.modules.values():
        scopes = [(None, fn) for fn in mod.functions.values()]
        for cls in mod.classes.values():
            scopes.extend((cls, fn) for fn in cls.methods.values())
        for cls, fn in scopes:
            c = _EdgeCollector(index, mod, cls, root)
            c.run(fn)
            for edge, locs in c.edges.items():
                edges.setdefault(edge, []).extend(locs)
    return edges


def _fmt_locs(locs: Sequence[Tuple[str, int, str]], limit: int = 2) -> str:
    return "; ".join(f"{p}:{ln} ({via})" for p, ln, via in locs[:limit])


def check(sources: Dict[str, SourceFile], root: str,
          order: Optional[Sequence[str]] = None,
          exceptions: Optional[Dict[Edge, str]] = None) -> List[Finding]:
    """Run the lock-order pass; ``order``/``exceptions`` default to the
    repo manifest (overridable for fixture tests)."""
    order = list(lock_manifest.LOCK_ORDER if order is None else order)
    exceptions = dict(lock_manifest.EXCEPTIONS
                      if exceptions is None else exceptions)
    findings: List[Finding] = []
    edges = build_graph(sources, root)
    for edge, reason in exceptions.items():
        if not str(reason).strip():
            findings.append(Finding(
                "lock-order", "distkeras_torch/analysis/lock_manifest.py", 1,
                f"exception {edge[0]} -> {edge[1]} has no reason string"))
        elif edge not in edges:
            # self-cleaning manifest: a dead entry would pre-suppress a
            # FUTURE genuine finding on this pair (the masked-bug class
            # the manifest's own docstring warns about)
            findings.append(Finding(
                "lock-order", "distkeras_torch/analysis/lock_manifest.py", 1,
                f"stale exception: edge {edge[0]} -> {edge[1]} no longer "
                f"exists in the acquisition graph — drop the EXCEPTIONS "
                f"entry"))
    live = {e: locs for e, locs in edges.items() if e not in exceptions}
    pos = {name: i for i, name in enumerate(order)}

    for (src, dst), locs in sorted(live.items()):
        path, line, via = locs[0]
        if src == dst:
            findings.append(Finding(
                "lock-order", path, line,
                f"re-acquisition of non-reentrant {src} while already "
                f"held ({via}) — deadlock (the monitor() shape); "
                f"order it or allow-list it in lock_manifest.EXCEPTIONS"))
            continue
        if src in pos and dst in pos and pos[src] > pos[dst]:
            findings.append(Finding(
                "lock-order", path, line,
                f"{src} held while acquiring {dst} inverts the declared "
                f"LOCK_ORDER (at {_fmt_locs(locs)})"))
        for node in (src, dst):
            if node not in pos:
                findings.append(Finding(
                    "lock-order", path, line,
                    f"lock {node} participates in acquisition edge "
                    f"{src} -> {dst} but is not declared in "
                    f"lock_manifest.LOCK_ORDER"))

    # cycle detection over the remaining (non-self) edges: any strongly
    # connected component with more than one node is a potential deadlock
    graph: Dict[str, Set[str]] = {}
    for (src, dst) in live:
        if src != dst:
            graph.setdefault(src, set()).add(dst)
            graph.setdefault(dst, set())
    for comp in _sccs(graph):
        if len(comp) > 1:
            cyc = sorted(comp)
            locs = [loc for e, ls in live.items()
                    if e[0] in comp and e[1] in comp for loc in ls]
            path, line = (locs[0][0], locs[0][1]) if locs else ("<graph>", 0)
            findings.append(Finding(
                "lock-order", path, line,
                f"lock acquisition cycle: {' -> '.join(cyc + [cyc[0]])} "
                f"(at {_fmt_locs(locs)})"))
    return apply_annotations(findings, sources, root, rule="lock-order")


def _sccs(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Tarjan strongly-connected components (iterative)."""
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    def strong(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == idx[node]:
                comp: Set[str] = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)

    for v in graph:
        if v not in idx:
            strong(v)
    return out


DEFAULT_SUBDIRS = (os.path.join("distkeras_torch", "runtime"),
                   os.path.join("distkeras_torch", "observability"))


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, SourceFile]] = None) -> List[Finding]:
    root = root or repo_root()
    if sources is None:
        sources = load_sources(python_files(root, DEFAULT_SUBDIRS))
    return check(sources, root)
