"""repro_torch.analysis — self-hosted concurrency correctness tooling.

The runtime's correctness rests on hand-maintained discipline: a dozen-plus
lock/condition-variable sites across the core, and a journaled event
vocabulary that replay, compaction, and listener dispatch must agree on.
This package machine-checks those invariants:

  locks.py     AST lock-discipline analyzer — lock inventory, inter-lock
               acquisition graph (nested ``with``/``acquire`` scopes plus
               cross-method edges through self-calls), cycle detection,
               blocking calls under a lock, ``Condition.wait`` outside a
               predicate loop.
  events.py    Event-protocol checker — emitted vs consumed vs declared
               (the ``EVENTS`` registry in store.py) journal event names,
               plus the declared task-lifecycle state machine checked
               against every ``transition(TaskState.X)`` site.
  watchdog.py  Runtime lock-order watchdog — opt-in instrumented-lock mode
               (``REPRO_LOCK_WATCHDOG=1``) that records per-thread
               acquisition sequences, merges them into an order graph, and
               fails on a cycle or a held-lock wall-time ceiling.

Rule codes are stable (docs/analysis.md has the catalog):

  RPX001  static lock-order cycle / self-deadlock on a non-reentrant lock
  RPX002  blocking call while holding a lock
  RPX003  Condition.wait() not wrapped in a predicate (while) loop
  RPX004  event emitted but never consumed by replay/compaction/listeners
  RPX005  event consumed but never emitted
  RPX006  event name not declared in the EVENTS registry
  RPX007  task-state transition outside the declared state machine
  RPX008  runtime lock-order cycle (watchdog)
  RPX009  held-lock wall time exceeded the ceiling (watchdog)

``python -m repro_torch.analysis`` runs the static passes over the port's
runtime source; ``baseline.txt`` (committed) lists the intentional
exceptions, one justified key per line.  CI fails on any non-baselined
finding.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class Finding:
    """One analyzer finding.

    ``key`` is the stable baseline identity: rule code plus the semantic
    site (module/qualname/lock or event name) — never a line number, so a
    committed baseline survives unrelated edits."""
    code: str
    path: str
    line: int
    message: str
    key: str

    def render(self) -> str:
        return f"{self.code} {self.path}:{self.line}: {self.message}"


def load_baseline(path: Path) -> Dict[str, str]:
    """Parse the committed baseline: ``<finding key>  # justification``
    per line; blank lines and full-line comments ignored.  Every entry
    must carry a justification — an unexplained suppression is itself an
    error (reported by the caller via ``validate``)."""
    entries: Dict[str, str] = {}
    if not path.exists():
        return entries
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, _, why = line.partition("#")
        entries[key.strip()] = why.strip()
    return entries


def apply_baseline(findings: List[Finding], baseline: Dict[str, str],
                   ) -> Tuple[List[Finding], List[str], List[str]]:
    """Split findings into (new, suppressed-keys, stale-baseline-keys).

    Stale entries (baselined keys no finding matches any more) are
    surfaced so the baseline shrinks as fixes land instead of rotting."""
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    suppressed = [k for k in baseline if k in keys]
    stale = [k for k in baseline if k not in keys]
    return new, suppressed, stale


__all__ = ["Finding", "load_baseline", "apply_baseline"]
