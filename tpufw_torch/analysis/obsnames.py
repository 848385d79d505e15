"""TPU005 — observability-name hygiene (port of
``tpufw.analysis.obsnames``).

The telemetry stack is only queryable if names stay closed-world: an
event ``kind`` outside ``tpufw_torch.obs.events.SCHEMA`` raises at emit
time (on whichever code path finally runs it), and a metric name that
drifts from the ``docs/torch/OBSERVABILITY.md`` catalog breaks every
dashboard and alert built on the documented series (the port serves
``tpufw``'s series names). This rule checks both statically:

- every literal first argument to ``.emit(...)`` must be a kind
  declared in the ``SCHEMA`` dict of ``tpufw_torch/obs/events.py``;
- every literal (or constant-resolvable) name passed to
  ``.counter()/.gauge()/.histogram()`` must start with ``tpufw_`` and
  appear in the metric catalog;
- serve.py-style prefixing wrappers (a class with a string ``PREFIX``
  attribute whose ``inc/register/reset`` methods prepend it) are
  resolved: the short names at their call sites are checked as
  ``PREFIX + name``, including the gauge dict handed to ``render``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set

from tpufw_torch.analysis import callgraph as cg
from tpufw_torch.analysis.core import Checker, Finding, Project, SourceFile

EVENTS_MODULE = "tpufw_torch/obs/events.py"
CATALOG_DOC = "docs/torch/OBSERVABILITY.md"

_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
_WRAPPER_METHODS = {"inc", "register", "reset"}
_METRIC_TOKEN_RE = re.compile(r"tpufw_[a-z0-9_]+")


def schema_kinds(project: Project) -> Set[str]:
    f = project.file(EVENTS_MODULE)
    if f is None or f.tree is None:
        return set()
    kinds: Set[str] = set()
    for node in f.tree.body:
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "SCHEMA" for t in targets
        ):
            continue
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(
                    k.value, str
                ):
                    kinds.add(k.value)
    return kinds


def doc_metric_names(project: Project) -> Set[str]:
    text = project.read_doc(CATALOG_DOC)
    if text is None:
        return set()
    return set(_METRIC_TOKEN_RE.findall(text))


def _metric_prefixes(project: Project) -> Set[str]:
    """String PREFIX class attributes (the serve.py wrapper idiom)."""
    prefixes: Set[str] = set()
    for f in project.files:
        if f.tree is None:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and any(
                        isinstance(t, ast.Name) and t.id == "PREFIX"
                        for t in stmt.targets
                    )
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    prefixes.add(stmt.value.value)
    return prefixes


class ObsNameChecker(Checker):
    rule = "TPU005"
    name = "obs-name-hygiene"
    severity = "error"

    def check(self, project: Project) -> Iterator[Finding]:
        index = cg.ModuleIndex(project)
        kinds = schema_kinds(project)
        doc_names = doc_metric_names(project)
        prefixes = _metric_prefixes(project)
        have_doc = project.read_doc(CATALOG_DOC) is not None
        for f in project.files:
            if f.tree is None or f.relpath == EVENTS_MODULE:
                continue
            mod = cg.module_name(f.relpath)
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                if not isinstance(node.func, ast.Attribute):
                    continue
                attr = node.func.attr
                if attr == "emit" and kinds:
                    yield from self._check_emit(f, node, kinds)
                elif attr in _METRIC_FACTORIES and have_doc:
                    yield from self._check_metric(
                        f, index, mod, node, doc_names
                    )
                elif attr in _WRAPPER_METHODS and prefixes and have_doc:
                    yield from self._check_wrapped(
                        f, node, prefixes, doc_names
                    )
                elif attr == "render" and prefixes and have_doc:
                    yield from self._check_render_gauges(
                        f, node, prefixes, doc_names
                    )

    def _check_emit(
        self, f: SourceFile, node: ast.Call, kinds: Set[str]
    ) -> Iterator[Finding]:
        if not node.args:
            return
        a0 = node.args[0]
        if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
            if a0.value not in kinds:
                yield self.finding(
                    f,
                    node,
                    f"event kind {a0.value!r} is not declared in "
                    f"{EVENTS_MODULE} SCHEMA — emit() will raise at "
                    "runtime on this path",
                    symbol=f"event-kind:{a0.value}",
                )

    def _check_metric(
        self,
        f: SourceFile,
        index: cg.ModuleIndex,
        mod: str,
        node: ast.Call,
        doc_names: Set[str],
    ) -> Iterator[Finding]:
        if not node.args:
            return
        name = index.resolve_str(node.args[0], mod)
        if name is None:
            # Dynamic name (wrapper internals like self.PREFIX + name)
            # — the wrapper call sites are checked instead.
            return
        yield from self._validate_name(f, node, name, doc_names)

    def _check_wrapped(
        self,
        f: SourceFile,
        node: ast.Call,
        prefixes: Set[str],
        doc_names: Set[str],
    ) -> Iterator[Finding]:
        # metrics.inc("requests_total") — receiver must look like a
        # metrics wrapper, otherwise .inc() on a Counter itself (a
        # value, not a name) would be misread.
        base = cg.attr_chain(node.func)
        if base is None or not any("metric" in part for part in base):
            return
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ):
                yield from self._validate_wrapped_name(
                    f, node, arg.value, prefixes, doc_names
                )

    def _check_render_gauges(
        self,
        f: SourceFile,
        node: ast.Call,
        prefixes: Set[str],
        doc_names: Set[str],
    ) -> Iterator[Finding]:
        base = cg.attr_chain(node.func)
        if base is None or not any("metric" in part for part in base):
            return
        for arg in node.args:
            if isinstance(arg, ast.Dict):
                for k in arg.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                        k.value, str
                    ):
                        yield from self._validate_wrapped_name(
                            f, node, k.value, prefixes, doc_names
                        )

    def _validate_wrapped_name(
        self,
        f: SourceFile,
        node: ast.Call,
        short: str,
        prefixes: Set[str],
        doc_names: Set[str],
    ) -> Iterator[Finding]:
        candidates = {p + short for p in prefixes}
        if candidates & doc_names:
            return
        shown = min(candidates)
        yield self.finding(
            f,
            node,
            f"metric {shown!r} (wrapper short name {short!r}) is not "
            f"in the {CATALOG_DOC} catalog — add it to the doc or fix "
            "the name",
            symbol=f"metric:{shown}",
        )

    def _validate_name(
        self,
        f: SourceFile,
        node: ast.Call,
        name: str,
        doc_names: Set[str],
    ) -> Iterator[Finding]:
        if not name.startswith("tpufw_"):
            yield self.finding(
                f,
                node,
                f"metric name {name!r} must carry the tpufw_ prefix "
                "(one namespace for every scrape)",
                symbol=f"metric-prefix:{name}",
            )
            return
        if name not in doc_names:
            yield self.finding(
                f,
                node,
                f"metric {name!r} is not in the {CATALOG_DOC} catalog "
                "— add it to the doc or fix the name",
                symbol=f"metric:{name}",
            )
