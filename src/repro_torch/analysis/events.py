"""Event-protocol + task-lifecycle checker (RPX004-RPX007).

The journal's event vocabulary has three parties that must agree:

  * emitters   — ``record_event("NAME", ...)`` call sites and the literal
                 ``{"event": "NAME", ...}`` records the store itself
                 writes (STATE, the _SNAPSHOT compaction header);
  * consumers  — ``_replay``, ``_maybe_compact``, checkpoint replay,
                 listener dispatch, benchmarks and tests that filter
                 ``e["event"] == "NAME"``;
  * the registry — ``EVENTS`` in store.py, the single declared source of
                 truth.

Rules:

RPX004  emitted but never consumed anywhere in the scanned scope —
        either dead telemetry or a consumer someone forgot to write
        (forensic-only events are baselined with a justification).
RPX005  consumed but never emitted — a typo'd or stale filter that can
        never match (this is the "replay silently dropped the stream"
        class of bug).
RPX006  an event name used (either side) that the EVENTS registry does
        not declare.
RPX007  a ``transition(TaskState.X)`` site targets a state the declared
        STATE_MACHINE (futures.py) has no inbound edge for, or the
        machine itself drifts from the TaskState enum.

Consumption detection is dataflow-lite: direct comparisons against
``<expr>["event"]`` / ``<expr>.get("event")`` or variables assigned from
them count as *strict* consumption (drives RPX005/RPX006); registry
names inside containers compared against event-set variables (the
``{"A", "B"} <= kinds`` test idiom) count as *loose* consumption
(suppresses RPX004 only).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import Finding


@dataclass
class EventUsage:
    registry: Dict[str, str] = field(default_factory=dict)   # attr -> value
    emitted: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    consumed: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    consumed_loose: Set[str] = field(default_factory=set)

    def note(self, table: Dict[str, List[Tuple[str, int]]],
             name: str, path: str, line: int):
        table.setdefault(name, []).append((path, line))


def _const_str(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _events_attr(node: ast.expr, registry: Dict[str, str]) -> Optional[str]:
    """Resolve ``EVENTS.X`` to its registered string value."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "EVENTS":
        return registry.get(node.attr, f"<EVENTS.{node.attr}?>")
    return None


def _name_of(node: ast.expr, registry: Dict[str, str]) -> Optional[str]:
    return _const_str(node) if _const_str(node) is not None \
        else _events_attr(node, registry)


def _container_names(node: ast.expr,
                     registry: Dict[str, str]) -> List[str]:
    out = []
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for el in node.elts:
            n = _name_of(el, registry)
            if n is not None:
                out.append(n)
    return out


def _is_event_expr(node: ast.expr) -> bool:
    """``<expr>["event"]`` or ``<expr>.get("event", ...)``."""
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return _const_str(sl) == "event"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        return _const_str(node.args[0]) == "event"
    return False


def extract_registry(sources: Dict[str, str]) -> Dict[str, str]:
    """Find ``class EVENTS`` and return its ``attr -> value`` mapping."""
    for path, src in sources.items():
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == "EVENTS":
                reg = {}
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign):
                        v = _const_str(stmt.value)
                        if v is None:
                            continue
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                reg[tgt.id] = v
                return reg
    return {}


class _EventWalker(ast.NodeVisitor):
    def __init__(self, path: str, usage: EventUsage):
        self.path = path
        self.u = usage
        # names assigned from e["event"] (scalars) / event comprehensions
        self.scalar_vars: Set[str] = set()
        self.collection_vars: Set[str] = set()

    def visit_Assign(self, node: ast.Assign):
        val = node.value
        is_scalar = _is_event_expr(val)
        is_coll = False
        if isinstance(val, (ast.SetComp, ast.ListComp, ast.GeneratorExp)):
            is_coll = _is_event_expr(val.elt)
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if is_scalar:
                    self.scalar_vars.add(tgt.id)
                if is_coll:
                    self.collection_vars.add(tgt.id)
        self.generic_visit(node)

    def _side_is_event(self, node: ast.expr) -> bool:
        if _is_event_expr(node):
            return True
        return isinstance(node, ast.Name) and node.id in self.scalar_vars

    def _side_is_event_collection(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name) and node.id in self.collection_vars:
            return True
        if isinstance(node, (ast.SetComp, ast.ListComp, ast.GeneratorExp)):
            return _is_event_expr(node.elt)
        return False

    def visit_Compare(self, node: ast.Compare):
        sides = [node.left] + list(node.comparators)
        strict = any(self._side_is_event(s) for s in sides)
        loose = any(self._side_is_event_collection(s) for s in sides)
        if strict or loose:
            for s in sides:
                n = _name_of(s, self.u.registry)
                names = [n] if n is not None else _container_names(
                    s, self.u.registry)
                for name in names:
                    if strict:
                        self.u.note(self.u.consumed, name,
                                    self.path, node.lineno)
                    else:
                        self.u.consumed_loose.add(name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if attr == "record_event" and node.args:
            n = _name_of(node.args[0], self.u.registry)
            if n is not None:
                self.u.note(self.u.emitted, n, self.path, node.lineno)
        self.generic_visit(node)

    def visit_Dict(self, node: ast.Dict):
        # store-internal emissions: {"event": "STATE", ...} record literals
        for k, v in zip(node.keys, node.values):
            if k is not None and _const_str(k) == "event":
                n = _name_of(v, self.u.registry)
                if n is not None:
                    self.u.note(self.u.emitted, n, self.path, node.lineno)
        self.generic_visit(node)


def collect_event_usage(sources: Dict[str, str],
                        registry: Optional[Dict[str, str]] = None,
                        ) -> EventUsage:
    usage = EventUsage(registry if registry is not None
                       else extract_registry(sources))
    for path, src in sources.items():
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        _EventWalker(path, usage).visit(tree)
    return usage


def analyze_events(sources: Dict[str, str],
                   registry: Optional[Dict[str, str]] = None,
                   ) -> List[Finding]:
    """Protocol-drift pass over ``{path: source}`` (core + benchmarks +
    tests: emitters and consumers both live in scope)."""
    u = collect_event_usage(sources, registry)
    findings: List[Finding] = []
    declared = set(u.registry.values())
    if not u.registry:
        findings.append(Finding(
            "RPX006", "", 0,
            "no EVENTS registry found (expected `class EVENTS` in "
            "store.py) — every event name is undeclared",
            "RPX006:<no-registry>"))
    consumed_any = set(u.consumed) | u.consumed_loose
    for name in sorted(set(u.emitted) - consumed_any):
        path, line = u.emitted[name][0]
        findings.append(Finding(
            "RPX004", path, line,
            f"event {name!r} is emitted but never consumed by replay, "
            f"compaction, listeners, benchmarks, or tests",
            f"RPX004:{name}"))
    for name in sorted(set(u.consumed) - set(u.emitted)):
        path, line = u.consumed[name][0]
        findings.append(Finding(
            "RPX005", path, line,
            f"event {name!r} is consumed (filtered/compared) but no "
            f"emitter exists — the filter can never match",
            f"RPX005:{name}"))
    if u.registry:
        for name in sorted((set(u.emitted) | set(u.consumed)) - declared):
            sites = u.emitted.get(name) or u.consumed.get(name)
            path, line = sites[0]
            findings.append(Finding(
                "RPX006", path, line,
                f"event {name!r} is not declared in the EVENTS registry",
                f"RPX006:{name}"))
    return findings


# --------------------------- state machine ------------------------------ #

def _extract_state_machine(sources: Dict[str, str],
                           ) -> Tuple[Set[str], Dict[str, Set[str]],
                                      Optional[str]]:
    """(enum members, machine edges, defining path) from the module that
    declares TaskState + STATE_MACHINE."""
    members: Set[str] = set()
    machine: Dict[str, Set[str]] = {}
    where: Optional[str] = None
    for path, src in sources.items():
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "TaskState":
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign):
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                members.add(tgt.id)
                where = path
            if isinstance(node, ast.Assign):
                tgts = [t.id for t in node.targets
                        if isinstance(t, ast.Name)]
                if "STATE_MACHINE" in tgts and isinstance(node.value,
                                                          ast.Dict):
                    for k, v in zip(node.value.keys, node.value.values):
                        ks = _taskstate_attr(k)
                        if ks is None:
                            continue
                        targets = set()
                        if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                            for el in v.elts:
                                t = _taskstate_attr(el)
                                if t is not None:
                                    targets.add(t)
                        machine[ks] = targets
                    where = path
    return members, machine, where


def _taskstate_attr(node: Optional[ast.expr]) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "TaskState":
        return node.attr
    return None


class _TransitionWalker(ast.NodeVisitor):
    def __init__(self, path: str, sites: List[Tuple[str, int, str, str]]):
        self.path = path
        self.sites = sites
        self.qual_stack: List[str] = []

    def visit_ClassDef(self, node: ast.ClassDef):
        self.qual_stack.append(node.name)
        self.generic_visit(node)
        self.qual_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.qual_stack.append(node.name)
        self.generic_visit(node)
        self.qual_stack.pop()

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "transition" \
                and node.args:
            state = _taskstate_attr(node.args[0])
            if state is not None:
                qual = ".".join(self.qual_stack) or "<module>"
                self.sites.append((self.path, node.lineno, qual, state))
        self.generic_visit(node)


def analyze_state_machine(sources: Dict[str, str]) -> List[Finding]:
    members, machine, where = _extract_state_machine(sources)
    findings: List[Finding] = []
    if not members:
        return findings                       # no TaskState in scope
    if not machine:
        findings.append(Finding(
            "RPX007", where or "", 0,
            "TaskState exists but no STATE_MACHINE declares its legal "
            "transitions",
            "RPX007:machine:<missing>"))
        return findings
    for m in sorted(members - set(machine)):
        findings.append(Finding(
            "RPX007", where or "", 0,
            f"state {m} has no outgoing-edge entry in STATE_MACHINE",
            f"RPX007:machine:{m}"))
    for m in sorted(set(machine) - members):
        findings.append(Finding(
            "RPX007", where or "", 0,
            f"STATE_MACHINE declares unknown state {m}",
            f"RPX007:machine:{m}"))
    inbound = {t for targets in machine.values() for t in targets}
    sites: List[Tuple[str, int, str, str]] = []
    for path, src in sources.items():
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        _TransitionWalker(path, sites).visit(tree)
    for path, line, qual, state in sites:
        module = path.rsplit("/", 1)[-1].removesuffix(".py")
        if state not in members:
            findings.append(Finding(
                "RPX007", path, line,
                f"{qual} transitions to undeclared state {state}",
                f"RPX007:{module}:{qual}:{state}"))
        elif state not in inbound:
            findings.append(Finding(
                "RPX007", path, line,
                f"{qual} transitions to {state}, which STATE_MACHINE "
                f"gives no inbound edge",
                f"RPX007:{module}:{qual}:{state}"))
    return findings
