"""Lock-discipline static analyzer (RPX001-RPX003).

Pure-AST pass over the runtime's own source.  Three rules:

RPX001  The inter-lock acquisition graph has a cycle.  Edges come from
        nested ``with``/``acquire`` scopes inside one method and from
        cross-method propagation through self-calls: if ``m1`` holds A
        and calls ``self.m2`` which (transitively) acquires B, that is an
        A→B edge even though no single method nests the two.  A self-edge
        on a non-reentrant ``Lock``/``Condition`` is reported as an
        immediate self-deadlock.
RPX002  A blocking call runs while a lock is held: ``pickle.*``,
        file/pipe I/O (``read``/``write``/``flush``/``send``/``recv``
        methods, ``open``, ``os.fsync``/``os.replace``), ``time.sleep``,
        anything in ``subprocess``, ``Future.result()``, ``Thread.join``,
        or a (non-releasing) ``Event.wait``.  Deliberate exceptions are
        baselined with a justification, not silenced in code.
RPX003  ``Condition.wait()`` outside a ``while`` predicate loop — a bare
        ``if``-guarded or unguarded wait misses spurious wakeups and
        notify races.  ``wait_for`` carries its own predicate and is
        exempt.

The analyzer is deliberately conservative (it over-approximates "held"):
a finding means "this pattern is present", not "this deadlocks on every
path" — the committed baseline is where human judgment about documented
exceptions lives.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import Finding

# threading factory -> lock kind (Events matter only for the blocking-
# wait rule; Semaphores participate in ordering like plain locks)
_FACTORIES = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition",
              "Event": "Event", "Semaphore": "Semaphore",
              "BoundedSemaphore": "Semaphore"}

_IO_METHODS = {"read", "readline", "readlines", "write", "writelines",
               "flush", "recv", "recv_bytes", "send", "send_bytes",
               "sendall"}
_PICKLE_FNS = {"dumps", "loads", "dump", "load"}
_OS_BLOCKING = {"fsync", "replace", "rename", "read", "write"}

# lock identity: (owner, attr) — owner is "module.Class" for self
# attributes, "module.Class.method" for function-local locks
LockId = Tuple[str, str]


@dataclass
class LockInfo:
    kind: str
    line: int
    display: str                      # "Class._lock" — stable across moves


@dataclass
class _Edge:
    src: LockId
    dst: LockId
    path: str
    line: int
    qual: str
    via: Optional[str] = None         # callee qualname for self-call edges


@dataclass
class LockGraph:
    locks: Dict[LockId, LockInfo] = field(default_factory=dict)
    edges: List[_Edge] = field(default_factory=list)

    def edge_pairs(self) -> Set[Tuple[LockId, LockId]]:
        return {(e.src, e.dst) for e in self.edges}


def _lock_factory_kind(node: ast.expr) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading":
        return _FACTORIES.get(f.attr)
    if isinstance(f, ast.Name):
        return _FACTORIES.get(f.id)
    return None


def _is_self_attr(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _ModuleLocks:
    """Inventory pass: every Lock/RLock/Condition/Event attribute assigned
    to ``self`` anywhere in a class, plus Condition-wraps-lock aliases."""

    def __init__(self, module: str, tree: ast.Module):
        self.module = module
        # (cls, attr) -> LockInfo ; aliases: cv attr -> underlying lock
        self.attrs: Dict[Tuple[str, str], LockInfo] = {}
        self.alias: Dict[Tuple[str, str], str] = {}
        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                kind = _lock_factory_kind(node.value)
                if kind is None:
                    continue
                for tgt in node.targets:
                    attr = _is_self_attr(tgt)
                    if attr is None:
                        continue
                    self.attrs[(cls.name, attr)] = LockInfo(
                        kind, node.lineno, f"{cls.name}.{attr}")
                    # Condition(self._lock): the cv *is* that lock for
                    # ordering purposes
                    if kind == "Condition" and node.value.args:
                        under = _is_self_attr(node.value.args[0])
                        if under is not None:
                            self.alias[(cls.name, attr)] = under

    def resolve(self, cls: str, attr: str) -> Optional[Tuple[str, LockInfo]]:
        """Canonical attr (through Condition aliases) + info, or None."""
        seen = set()
        while (cls, attr) in self.alias and (cls, attr) not in seen:
            seen.add((cls, attr))
            attr = self.alias[(cls, attr)]
        info = self.attrs.get((cls, attr))
        return (attr, info) if info is not None else None

    def resolve_unique(self, attr: str) -> Optional[Tuple[str, str,
                                                          LockInfo]]:
        """Resolve a lock attribute reached through a non-``self``
        receiver (``w.send_lock``): only when the attribute name is
        unambiguous across the module's classes — ``_lock`` exists on
        half the runtime and is never resolved this way."""
        hits = [(c, a, i) for (c, a), i in self.attrs.items() if a == attr]
        return hits[0] if len(hits) == 1 else None


@dataclass
class _MethodFacts:
    qual: str                                   # "Class.method"
    acquires: Set[LockId] = field(default_factory=set)
    # (held-locks-at-site, callee-qual, line)
    self_calls: List[Tuple[Tuple[LockId, ...], str, int]] = \
        field(default_factory=list)


class _MethodWalker:
    """Single-method pass: tracks the held-lock stack through nested
    ``with`` scopes and explicit acquire/release pairs, records
    acquisition edges, blocking calls under a lock, and unguarded waits."""

    def __init__(self, module: str, path: str, cls: str, qual: str,
                 inv: _ModuleLocks, graph: LockGraph,
                 findings: List[Finding], facts: _MethodFacts):
        self.module, self.path, self.cls, self.qual = module, path, cls, qual
        self.inv, self.graph, self.findings, self.facts = \
            inv, graph, findings, facts
        self.held: List[LockId] = []
        self.while_depth = 0
        # function-local lock/cv vars: name -> (LockId, kind)
        self.local: Dict[str, Tuple[LockId, str]] = {}

    # ------------------------------ helpers ----------------------------- #
    def _lock_of(self, node: ast.expr) -> Optional[Tuple[LockId, str]]:
        """Resolve an expression to (LockId, kind) if it names a lock."""
        attr = _is_self_attr(node)
        if attr is not None:
            r = self.inv.resolve(self.cls, attr)
            if r is not None:
                canon, info = r
                return ((f"{self.module}.{self.cls}", canon), info.kind)
            return None
        if isinstance(node, ast.Name) and node.id in self.local:
            return self.local[node.id]
        if isinstance(node, ast.Attribute):
            # non-self receiver (w.send_lock): attribute-name-unique only
            r = self.inv.resolve_unique(node.attr)
            if r is not None:
                cls, canon, info = r
                return ((f"{self.module}.{cls}", canon), info.kind)
        return None

    def _display(self, lid: LockId) -> str:
        owner, attr = lid
        return f"{owner.split('.', 1)[-1]}.{attr}"

    def _push(self, lid: LockId, kind: str, line: int):
        if lid in self.held:
            if kind in ("Lock", "Condition"):
                d = self._display(lid)
                self.findings.append(Finding(
                    "RPX001", self.path, line,
                    f"{self.qual} re-acquires non-reentrant {d} "
                    f"while already holding it (self-deadlock)",
                    f"RPX001:{self.module}:{self.qual}:self:{d}"))
            # re-entry adds no ordering edge either way
            self.held.append(lid)
            return
        for h in self.held:
            if h != lid:
                self.graph.edges.append(_Edge(
                    h, lid, self.path, line, self.qual))
        self.held.append(lid)
        self.facts.acquires.add(lid)

    def _pop(self, lid: LockId):
        if lid in self.held:
            # remove the innermost occurrence (re-entrant pairs nest)
            for i in range(len(self.held) - 1, -1, -1):
                if self.held[i] == lid:
                    del self.held[i]
                    break

    def _blocking(self, path: str, line: int, what: str):
        locks = ", ".join(self._display(h) for h in dict.fromkeys(self.held))
        self.findings.append(Finding(
            "RPX002", path, line,
            f"{self.qual} calls {what} while holding {locks}",
            f"RPX002:{self.module}:{self.qual}:{what}"))

    # ---------------------------- statements ---------------------------- #
    def walk(self, stmts: Sequence[ast.stmt]):
        for s in stmts:
            self.stmt(s)

    def stmt(self, s: ast.stmt):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                    # closure: runs later, not under held
        if isinstance(s, ast.ClassDef):
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            acquired: List[LockId] = []
            for item in s.items:
                self.scan_expr(item.context_expr)
                r = self._lock_of(item.context_expr)
                if r is not None:
                    lid, kind = r
                    self._push(lid, kind, s.lineno)
                    acquired.append(lid)
            self.walk(s.body)
            for lid in reversed(acquired):
                self._pop(lid)
            return
        if isinstance(s, ast.While):
            self.scan_expr(s.test)
            self.while_depth += 1
            self.walk(s.body)
            self.while_depth -= 1
            self.walk(s.orelse)
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self.scan_expr(s.iter)
            self.walk(s.body)
            self.walk(s.orelse)
            return
        if isinstance(s, ast.If):
            self.scan_expr(s.test)
            self.walk(s.body)
            self.walk(s.orelse)
            return
        if isinstance(s, ast.Try):
            self.walk(s.body)
            for h in s.handlers:
                self.walk(h.body)
            self.walk(s.orelse)
            self.walk(s.finalbody)
            return
        # leaf statements: remember local lock vars, then scan expressions
        if isinstance(s, ast.Assign):
            kind = _lock_factory_kind(s.value)
            if kind is not None:
                for tgt in s.targets:
                    if isinstance(tgt, ast.Name):
                        lid = (f"{self.module}.{self.qual}", tgt.id)
                        self.local[tgt.id] = (lid, kind)
                        self.graph.locks[lid] = LockInfo(
                            kind, s.lineno, f"{self.qual}:{tgt.id}")
                return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self.scan_expr(child)

    # --------------------------- expressions ---------------------------- #
    def scan_expr(self, e: ast.expr):
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                self.call(node)

    def call(self, c: ast.Call):
        f = c.func
        # --- explicit acquire/release on a known lock ---
        if isinstance(f, ast.Attribute):
            r = self._lock_of(f.value)
            if r is not None and f.attr == "acquire":
                self._push(r[0], r[1], c.lineno)
                return
            if r is not None and f.attr == "release":
                self._pop(r[0])
                return
            if f.attr == "wait" and r is not None:
                lid, kind = r
                if kind == "Condition":
                    if self.while_depth == 0:
                        d = self._display(lid)
                        self.findings.append(Finding(
                            "RPX003", self.path, c.lineno,
                            f"{self.qual} calls {d}.wait() outside a while "
                            f"predicate loop (misses spurious wakeups)",
                            f"RPX003:{self.module}:{self.qual}:{d}"))
                    return
                if kind == "Event" and self.held:
                    self._blocking(self.path, c.lineno,
                                   f"{self._display(lid)}.wait()")
                    return
        if not self.held:
            return
        # --- blocking calls under a held lock ---
        what = self._blocking_name(f)
        if what is not None:
            self._blocking(self.path, c.lineno, what)

    def _blocking_name(self, f: ast.expr) -> Optional[str]:
        if isinstance(f, ast.Name):
            return "open()" if f.id == "open" else None
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        if isinstance(base, ast.Name):
            if base.id in ("pickle", "serializer", "json", "marshal") \
                    and f.attr in _PICKLE_FNS:
                return f"{base.id}.{f.attr}"
            if base.id == "time" and f.attr == "sleep":
                return "time.sleep"
            if base.id == "os" and f.attr in _OS_BLOCKING:
                return f"os.{f.attr}"
            if base.id == "subprocess":
                return f"subprocess.{f.attr}"
        if f.attr == "result":
            return ".result()"
        if f.attr in _IO_METHODS:
            try:
                recv = ast.unparse(base)
            except Exception:            # pragma: no cover
                recv = "?"
            return f"{recv}.{f.attr}()"
        return None


def _methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            yield node
        elif isinstance(node, (ast.If, ast.Try)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.FunctionDef):
                    yield sub


def analyze_lock_discipline(sources: Dict[str, str],
                            ) -> Tuple[List[Finding], LockGraph]:
    """Run the lock-discipline pass over ``{display_path: source}``.

    Returns (findings, graph); findings carry stable baseline keys."""
    findings: List[Finding] = []
    graph = LockGraph()
    facts: Dict[str, _MethodFacts] = {}              # "mod:Cls.m" -> facts
    # pass 1: inventory + per-method walks
    per_module: List[Tuple[str, str, ast.Module, _ModuleLocks]] = []
    for path, src in sources.items():
        module = path.rsplit("/", 1)[-1].removesuffix(".py")
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding(
                "RPX000", path, e.lineno or 0, f"syntax error: {e.msg}",
                f"RPX000:{module}"))
            continue
        inv = _ModuleLocks(module, tree)
        for (cls, attr), info in inv.attrs.items():
            if (cls, attr) not in inv.alias:        # canonical locks only
                graph.locks[(f"{module}.{cls}", attr)] = info
        per_module.append((path, module, tree, inv))

    for path, module, tree, inv in per_module:
        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            for fn in _methods(cls):
                qual = f"{cls.name}.{fn.name}"
                mf = _MethodFacts(qual)
                facts[f"{module}:{qual}"] = mf
                w = _MethodWalker(module, path, cls.name, qual, inv,
                                  graph, findings, mf)
                w.walk(fn.body)
                # collect self-call sites with the held set they run under
                _collect_self_calls(module, cls.name, fn, inv, mf)

    # pass 2: cross-method edge propagation through self-calls
    _propagate(facts, graph, sources)

    # pass 3: cycles
    findings.extend(_cycles(graph))
    return findings, graph


class _SelfCallWalker(_MethodWalker):
    """Re-walk recording (held, callee) pairs for every self-call —
    separated from the main walk so findings are not duplicated."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.findings = []            # discard: already reported

    def call(self, c: ast.Call):
        f = c.func
        if isinstance(f, ast.Attribute):
            r = self._lock_of(f.value)
            if r is not None and f.attr == "acquire":
                self._push(r[0], r[1], c.lineno)
                return
            if r is not None and f.attr == "release":
                self._pop(r[0])
                return
            callee = None
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                callee = f"{self.cls}.{f.attr}"
            if callee is not None:
                self.facts.self_calls.append(
                    (tuple(dict.fromkeys(self.held)), callee, c.lineno))


def _collect_self_calls(module: str, cls: str, fn: ast.FunctionDef,
                        inv: _ModuleLocks, mf: _MethodFacts):
    g = LockGraph()                   # scratch: edges discarded
    w = _SelfCallWalker(module, "", cls, mf.qual, inv, g, [], mf)
    w.walk(fn.body)


def _propagate(facts: Dict[str, _MethodFacts], graph: LockGraph,
               sources: Dict[str, str]):
    """Fixpoint: trans_acquires(m) = acquires(m) ∪ ⋃ trans(callees);
    then every self-call made while holding H yields H→L edges for each
    transitively acquired L."""
    trans: Dict[str, Set[LockId]] = {k: set(v.acquires)
                                     for k, v in facts.items()}
    changed = True
    while changed:
        changed = False
        for key, mf in facts.items():
            module = key.split(":", 1)[0]
            for _, callee, _ in mf.self_calls:
                ck = f"{module}:{callee}"
                if ck in trans and not trans[ck] <= trans[key]:
                    trans[key] |= trans[ck]
                    changed = True
    path_of = {p.rsplit("/", 1)[-1].removesuffix(".py"): p for p in sources}
    for key, mf in facts.items():
        module = key.split(":", 1)[0]
        for held, callee, line in mf.self_calls:
            if not held:
                continue
            ck = f"{module}:{callee}"
            for lid in trans.get(ck, ()):
                for h in held:
                    if h == lid:
                        # re-entry through a self-call: only safe on an
                        # RLock — surfaced by the cycle pass as a
                        # self-edge below
                        kind = graph.locks.get(lid)
                        if kind is not None and kind.kind != "RLock":
                            graph.edges.append(_Edge(
                                h, lid, path_of.get(module, module), line,
                                mf.qual, via=callee))
                        continue
                    graph.edges.append(_Edge(
                        h, lid, path_of.get(module, module), line,
                        mf.qual, via=callee))


def _cycles(graph: LockGraph) -> List[Finding]:
    """Tarjan SCCs over the acquisition graph; every SCC larger than one
    lock (or a self-edge) is a deadlock-risk cycle."""
    adj: Dict[LockId, Set[LockId]] = {}
    for e in graph.edges:
        adj.setdefault(e.src, set()).add(e.dst)
        adj.setdefault(e.dst, set())
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    sccs: List[List[LockId]] = []
    counter = [0]

    def strongconnect(v: LockId):
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    def disp(lid: LockId) -> str:
        info = graph.locks.get(lid)
        return info.display if info else f"{lid[0]}.{lid[1]}"

    findings: List[Finding] = []
    self_edges = {(e.src, e.dst) for e in graph.edges if e.src == e.dst}
    for scc in sccs:
        if len(scc) < 2 and (scc[0], scc[0]) not in self_edges:
            continue
        names = sorted(disp(l) for l in scc)
        members = {l for l in scc}
        sites = sorted({(e.path, e.line, e.qual) for e in graph.edges
                        if e.src in members and e.dst in members})
        where = "; ".join(f"{q} ({p}:{ln})" for p, ln, q in sites[:4])
        path, line = (sites[0][0], sites[0][1]) if sites else ("", 0)
        findings.append(Finding(
            "RPX001", path, line,
            f"lock-order cycle between {{{', '.join(names)}}} — "
            f"acquisition sites: {where}",
            f"RPX001:{'->'.join(names)}"))
    return findings
