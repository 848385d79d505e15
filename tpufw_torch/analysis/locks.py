"""TPU009: lock discipline across the port's threaded classes (port of
``tpufw.analysis.locks``).

The serve scheduler, batcher, hang watchdog, flight recorder, and
prefetcher all share the same shape: a class owning a
``threading.Thread(target=self._loop)`` plus mutable state touched
from both the thread and the caller-facing API. The invariant is
classic monitor discipline — every attribute written on one side and
read on the other is accessed *only* under the owning lock — and a
violation is a torn read or lost update that surfaces as a rare
serving hang or a wrong gauge. TPU009 checks it statically, per class:

- Inventory lock attributes (``self._cv = threading.Condition()``,
  ``Lock``/``RLock``/``Semaphore``) and intrinsically thread-safe
  attributes (``Event``, ``queue.Queue``, ``deque``, ``local`` —
  exempt).
- Partition methods into thread-side (reachable from a
  ``Thread(target=self.m)`` entry via self-calls) and main-side.
- An attribute written after ``__init__`` and touched from both sides
  must be accessed inside ``with self.<lock>:`` or in a private helper
  whose every internal call site holds the lock (monitor helpers like
  serve's ``_fail_req`` stay clean without re-acquiring). When every
  write comes from ONE side, that side owns the attribute and may
  touch it lock-free (single-writer discipline — serve's scheduler
  thread over its pool); only the reading side must lock, for
  consistent snapshots. Writes from both sides demand the lock at
  every access.
- Separately, nested ``with lockA: ... with lockB:`` acquisitions are
  recorded as an order; observing both (A,B) and (B,A) anywhere in
  the class is a deadlock-shaped inversion (warning).

Scope is deliberately class-level: module-level closures that smuggle
state through nonlocals (a prefetch worker) are invisible here.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from tpufw_torch.analysis import callgraph as cg
from tpufw_torch.analysis.core import Checker, Finding, Project, SourceFile

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_SAFE_CTORS = {"Event", "Queue", "SimpleQueue", "LifoQueue",
               "PriorityQueue", "deque", "local", "Barrier"}
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "clear", "add", "discard", "update", "setdefault",
    "put", "put_nowait",
}
_IGNORED_METHODS = {"__init__", "__post_init__", "__del__"}


class _Access:
    __slots__ = ("method", "attr", "kind", "held", "node")

    def __init__(self, method: str, attr: str, kind: str,
                 held: Set[str], node: ast.AST):
        self.method = method
        self.attr = attr
        self.kind = kind  # "read" | "write"
        self.held = held  # locks held lexically at the access
        self.node = node


class _ClassModel:
    """Everything TPU009 needs to know about one ClassDef."""

    def __init__(self, cls: ast.ClassDef):
        self.cls = cls
        self.methods: Dict[str, ast.AST] = {
            m.name: m
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.lock_attrs: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        self.thread_targets: Set[str] = set()
        self.accesses: List[_Access] = []
        # method -> list of (callee_method, locks_held_at_call)
        self.self_calls: Dict[str, List[Tuple[str, Set[str]]]] = {}
        # ordered lock-acquisition pairs observed anywhere
        self.lock_pairs: Dict[Tuple[str, str], ast.AST] = {}
        self._inventory()
        for name, node in self.methods.items():
            self._scan_method(name, node)

    # ------------------------------------------------------ inventory

    def _inventory(self) -> None:
        for node in ast.walk(self.cls):
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            if isinstance(val, ast.Call):
                nm = cg.call_name(val)
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if nm in _LOCK_CTORS:
                        self.lock_attrs.add(attr)
                    elif nm in _SAFE_CTORS:
                        self.safe_attrs.add(attr)
            for sub in ast.walk(node.value):
                self._maybe_thread(sub)
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Call):
                self._maybe_thread(node)

    def _maybe_thread(self, node: ast.AST) -> None:
        if not (
            isinstance(node, ast.Call)
            and cg.call_name(node) == "Thread"
        ):
            return
        for kw in node.keywords:
            if kw.arg == "target":
                attr = _self_attr(kw.value)
                if attr is not None:
                    self.thread_targets.add(attr)

    # ----------------------------------------------------- per-method

    def _scan_method(self, name: str, fn: ast.AST) -> None:
        self.self_calls.setdefault(name, [])
        held: List[str] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.With):
                acquired: List[str] = []
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.lock_attrs:
                        for h in held:
                            if h != attr:
                                self.lock_pairs.setdefault(
                                    (h, attr), item.context_expr
                                )
                        held.append(attr)
                        acquired.append(attr)
                for s in node.body:
                    visit(s)
                for attr in acquired:
                    held.remove(attr)
                return
            self._record(name, node, set(held))
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    # Closures (cv.wait_for lambdas, worker defs) run
                    # with whatever the enclosing scope holds when
                    # they are *defined* under a with; treat them as
                    # part of the method at the current held set.
                    body = (
                        child.body
                        if isinstance(child.body, list)
                        else [child.body]
                    )
                    for s in body:
                        visit(s)
                    continue
                visit(child)

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            visit(stmt)

    def _record(
        self, method: str, node: ast.AST, held: Set[str]
    ) -> None:
        # self.m(...) internal calls.
        if isinstance(node, ast.Call):
            attr = _self_attr(node.func)
            if attr is not None and attr in self.methods:
                self.self_calls[method].append((attr, set(held)))
                return
            # self.X.append(...) — container mutation is a write.
            if isinstance(node.func, ast.Attribute):
                recv = _self_attr(node.func.value)
                if recv is not None and node.func.attr in _MUTATOR_METHODS:
                    self.accesses.append(
                        _Access(method, recv, "write", held, node)
                    )
        if isinstance(node, ast.Attribute):
            attr = _self_attr(node)
            if attr is None or attr in self.methods:
                return
            kind = (
                "write"
                if isinstance(node.ctx, (ast.Store, ast.Del))
                else "read"
            )
            self.accesses.append(_Access(method, attr, kind, held, node))
        elif isinstance(node, ast.Subscript):
            # self.X[i] = v / del self.X[i] mutate the container.
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                recv = _self_attr(node.value)
                if recv is not None:
                    self.accesses.append(
                        _Access(method, recv, "write", set(held), node)
                    )

    # ------------------------------------------------- derived facts

    def thread_side(self) -> Set[str]:
        """Methods reachable from a Thread target via self-calls."""
        out: Set[str] = set()
        frontier = [t for t in self.thread_targets if t in self.methods]
        while frontier:
            m = frontier.pop()
            if m in out:
                continue
            out.add(m)
            for callee, _held in self.self_calls.get(m, []):
                if callee not in out:
                    frontier.append(callee)
        return out

    def method_guards(self) -> Dict[str, Set[str]]:
        """Locks provably held on *every* internal call path into each
        private method. Thread targets and public methods are entry
        points (empty guard): callers outside the class hold nothing."""
        callers: Dict[str, List[Tuple[str, Set[str]]]] = {}
        for caller, calls in self.self_calls.items():
            for callee, held in calls:
                callers.setdefault(callee, []).append((caller, held))
        # Only private, internally-called, non-thread-entry methods can
        # inherit a guard; everything else can be entered lock-free.
        refinable = {
            m for m in self.methods
            if m.startswith("_")
            and not m.startswith("__")
            and m not in self.thread_targets
            and m in callers
        }
        guards: Dict[str, Set[str]] = {
            m: (set(self.lock_attrs) if m in refinable else set())
            for m in self.methods
        }
        for _ in range(len(self.methods) + 1):
            changed = False
            for m in refinable:
                eff: Optional[Set[str]] = None
                for caller, held in callers[m]:
                    g = held | guards.get(caller, set())
                    eff = g if eff is None else (eff & g)
                eff = eff or set()
                if eff != guards[m]:
                    guards[m] = eff
                    changed = True
            if not changed:
                break
        return guards


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class LockDisciplineChecker(Checker):
    rule = "TPU009"
    name = "lock-discipline"
    severity = "error"

    def check(self, project: Project) -> Iterator[Finding]:
        for f in project.files:
            if f.tree is None:
                continue
            for node in ast.walk(f.tree):
                if isinstance(node, ast.ClassDef):
                    yield from self._check_class(f, node)

    def _check_class(
        self, f: SourceFile, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        model = _ClassModel(cls)
        if not model.thread_targets or not model.lock_attrs:
            return
        thread_side = model.thread_side()
        guards = model.method_guards()
        by_attr: Dict[str, List[_Access]] = {}
        for a in model.accesses:
            if a.method in _IGNORED_METHODS:
                continue
            if a.attr in model.lock_attrs or a.attr in model.safe_attrs:
                continue
            if a.attr.startswith("__"):
                continue
            by_attr.setdefault(a.attr, []).append(a)
        for attr, accs in sorted(by_attr.items()):
            in_thread = [a for a in accs if a.method in thread_side]
            in_main = [a for a in accs if a.method not in thread_side]
            writes = [a for a in accs if a.kind == "write"]
            if not in_thread or not in_main or not writes:
                continue
            # Ownership: when ONE side performs every write, that side
            # may touch the attribute lock-free (single-writer
            # discipline — serve's scheduler thread over its pool);
            # only the READING side must take the lock, for consistent
            # snapshots. Writes from both sides are lost-update races:
            # then every access needs the lock.
            writer_sides = {
                a.method in thread_side for a in writes
            }
            if len(writer_sides) == 1:
                owner_is_thread = writer_sides == {True}
                candidates = [
                    a for a in accs
                    if (a.method in thread_side) != owner_is_thread
                ]
            else:
                candidates = accs
            unguarded = [
                a for a in candidates
                if not (a.held | guards.get(a.method, set()))
            ]
            if not unguarded:
                continue
            worst = min(
                unguarded, key=lambda a: getattr(a.node, "lineno", 0)
            )
            side = (
                "thread" if worst.method in thread_side else "caller"
            )
            locks = ", ".join(sorted(model.lock_attrs))
            yield self.finding(
                f,
                worst.node,
                f"{cls.name}.{attr} is shared between the "
                f"{cls.name} thread and its callers (written in "
                f"{writes[0].method!r}) but {worst.method!r} "
                f"accesses it from the {side} side without holding "
                f"a lock ({locks}); torn reads/lost updates follow",
                symbol=f"unguarded:{cls.name}.{attr}",
            )
        for (a, b), node in sorted(model.lock_pairs.items()):
            if (b, a) in model.lock_pairs and a < b:
                yield self.finding(
                    f,
                    node,
                    f"{cls.name} acquires {a!r} then {b!r} on one "
                    f"path and {b!r} then {a!r} on another — "
                    "lock-order inversion; pick one order",
                    symbol=f"lock-order:{cls.name}:{a},{b}",
                    severity="warning",
                )
