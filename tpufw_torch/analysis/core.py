"""tpulint core for the port (port of ``tpufw.analysis.core``): checker
plugin framework, file walker, suppression, baseline ratchet and output
formatting.

The rules check invariants that live between this package's subsystems
(the step loop, ``workloads/env``, ``obs/events``, the threaded serving
classes), not in any one expression. Everything here is stdlib ``ast``:
the lint runs in a bare container without torch.

Vocabulary
----------
- A :class:`Checker` owns one rule ID (``TPU001``..) and yields
  :class:`Finding` objects over a :class:`Project` (the parsed tree of
  every scanned file), so cross-file rules are first-class.
- Suppression is per-line: a trailing ``# tpulint: disable=TPU001``
  comment (or one alone on the preceding line) silences that rule on
  that line; ``# tpulint: disable-file=TPU004`` anywhere silences the
  whole file. A suppression carries its justification after the rule
  list; it is reviewed as code.
- The baseline (``tpufw_torch/analysis/baseline.json``) ratchets
  pre-existing findings: runs fail only on findings whose stable key is
  *not* in the baseline, and the baseline may only shrink. Keys exclude
  line numbers so unrelated edits don't churn it.

Layers. ``tpufw``'s lint has five (python, deploy, protocol, lifetime,
all); the port runs the python layer, and ``all`` is every ported layer.
``protocol`` and ``lifetime`` are item 13d(b); ``deploy`` scans
``deploy/``, which the port leaves to ``tpufw``. Asking for one of them
is an error, never a silent pass.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

LAYERS = ("python", "all")

#: Layers of ``tpufw``'s lint the port does not run, and why.
UNPORTED_LAYERS = {
    "protocol": "not ported yet: item 13d(b) (TPU015-018)",
    "lifetime": "not ported yet: item 13d(b) (TPU019-021)",
    "deploy": "not ported: it scans deploy/, which tpufw's lint covers "
              "(python -m tpufw.analysis --layer deploy)",
}

_SUPPRESS_RE = re.compile(
    r"#\s*tpulint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)"
)

# Directories never worth parsing (caches, VCS, vendored assets).
_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "node_modules", ".venv"}


def scan_suppression_lines(
    lines: Sequence[str],
) -> tuple[Set[str], Dict[int, Set[str]]]:
    """(file_suppressed, line -> rules) from ``# tpulint:`` comments.

    A trailing comment covers its line, a standalone comment covers its
    block plus the first non-comment line after it, and ``disable-file``
    covers the whole file.
    """
    file_suppressed: Set[str] = set()
    line_suppressed: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",")}
        if m.group(1) == "disable-file":
            file_suppressed |= rules
            continue
        line_suppressed.setdefault(i, set()).update(rules)
        # A comment alone on its line covers the rest of its comment
        # block (the justification) and the first code line after it —
        # for statements too long to carry a trailing comment.
        if line.lstrip().startswith("#"):
            j = i + 1
            while j <= len(lines):
                line_suppressed.setdefault(j, set()).update(rules)
                stripped = lines[j - 1].lstrip()
                if stripped and not stripped.startswith("#"):
                    break  # covered the first code line; stop
                j += 1
    return file_suppressed, line_suppressed


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location.

    ``symbol`` is the stable anchor used for baseline identity (an
    env-var name, function qname, ...): baselines keyed on
    ``rule:path:symbol`` survive line drift from unrelated edits.
    """

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    severity: str = "error"
    symbol: str = ""

    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol or self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule} [{self.severity}] {self.message}"
        )


class SourceFile:
    """One parsed python file + its suppression table."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as e:
            self.parse_error = e
        self.file_suppressed, self.line_suppressed = scan_suppression_lines(
            self.lines
        )

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressed:
            return True
        return rule in self.line_suppressed.get(line, set())


class Project:
    """Every scanned file, plus the repo root for out-of-scan lookups
    (the port's docs) that cross-file rules need."""

    def __init__(self, files: Sequence[SourceFile], root: str):
        self.files = list(files)
        self.root = root
        self._by_rel = {f.relpath: f for f in self.files}
        self._env_catalog: Optional["EnvCatalog"] = None

    def file(self, relpath: str) -> Optional[SourceFile]:
        return self._by_rel.get(relpath.replace(os.sep, "/"))

    def read_doc(self, relpath: str) -> Optional[str]:
        """Text of a repo file outside the scan set (the catalogs)."""
        p = os.path.join(self.root, relpath)
        try:
            with open(p, encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            return None

    def env_catalog(self) -> "EnvCatalog":
        if self._env_catalog is None:
            self._env_catalog = load_env_catalog(self)
        return self._env_catalog

    def is_suppressed(self, rule: str, path: str, line: int) -> bool:
        src = self.file(path)
        return src is not None and src.is_suppressed(rule, line)


# ----------------------------------------------------------- env catalog

#: The port's own knob catalog (typed table rows), and every doc page
#: where a TPUFW_* mention counts as "documented". ``tpufw``'s
#: ``docs/ENV.md`` lists ``tpufw``'s knobs and is not read here.
ENV_CATALOG_DOC = "docs/torch/ENV.md"
ENV_DOC_PAGES = (
    "docs/torch/ENV.md",
    "docs/torch/OBSERVABILITY.md",
)

_ENV_NAME_RE = re.compile(r"TPUFW_[A-Z0-9_]+")
# A catalog table row: | `TPUFW_X` | type | default | meaning |
_ENV_ROW_RE = re.compile(
    r"^\|\s*`(TPUFW_[A-Z0-9_]+)`\s*\|\s*([^|]+?)\s*\|\s*([^|]*?)\s*\|"
)


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One typed row of the catalog table."""

    name: str
    type: str  # "int" | "float" | "str" | "bool" | "opt int" | ...
    default: str


@dataclasses.dataclass(frozen=True)
class EnvCatalog:
    """The catalog pages parsed once for TPU004."""

    entries: Dict[str, EnvKnob]  # typed catalog table rows
    catalog_names: Set[str]  # every TPUFW_* mention in the catalog
    doc_names: Set[str]  # every TPUFW_* mention in any doc page


def load_env_catalog(project: Project) -> EnvCatalog:
    entries: Dict[str, EnvKnob] = {}
    catalog_names: Set[str] = set()
    doc_names: Set[str] = set()
    for page in ENV_DOC_PAGES:
        text = project.read_doc(page)
        if text is None:
            continue
        found = set(_ENV_NAME_RE.findall(text))
        doc_names |= found
        if page != ENV_CATALOG_DOC:
            continue
        catalog_names |= found
        for line in text.splitlines():
            m = _ENV_ROW_RE.match(line)
            if m:
                name, type_str, default = m.groups()
                entries.setdefault(
                    name, EnvKnob(name, type_str.strip(), default.strip())
                )
    return EnvCatalog(
        entries=entries, catalog_names=catalog_names, doc_names=doc_names
    )


class Checker:
    """Base class for one rule. Subclasses set ``rule``/``name`` and
    implement :meth:`check`; suppression and baseline filtering happen
    in the runner, so checkers yield every raw finding."""

    rule = "TPU000"
    name = "abstract"
    severity = "error"
    # Which scan layer feeds the rule; run_analysis(layer=...) filters
    # on it.
    layer = "python"

    def check(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(
        self,
        file: SourceFile,
        node: ast.AST,
        message: str,
        symbol: str = "",
        severity: Optional[str] = None,
    ) -> Finding:
        return Finding(
            rule=self.rule,
            path=file.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            severity=severity or self.severity,
            symbol=symbol,
        )


def find_repo_root(start: str) -> str:
    """Nearest ancestor containing pyproject.toml (fallback: start)."""
    start = os.path.abspath(start)
    if os.path.isfile(start):
        start = os.path.dirname(start)
    d = start
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def iter_py_files(
    paths: Sequence[str], root: str
) -> List[tuple[str, str]]:
    """(abspath, relpath) for every .py under ``paths``, deduped and
    sorted. Split from :func:`collect_files` so the replay cache can
    hash contents without paying for a parse."""
    out: List[tuple[str, str]] = []
    seen: Set[str] = set()

    def add(path: str) -> None:
        ap = os.path.abspath(path)
        if ap in seen or not ap.endswith(".py"):
            return
        seen.add(ap)
        out.append((ap, os.path.relpath(ap, root)))

    for p in paths:
        if os.path.isfile(p):
            add(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in _SKIP_DIRS and not d.startswith(".")
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    add(os.path.join(dirpath, fn))
    out.sort(key=lambda pair: pair[1])
    return out


def collect_files(paths: Sequence[str], root: str) -> List[SourceFile]:
    out: List[SourceFile] = []
    for ap, rel in iter_py_files(paths, root):
        try:
            with open(ap, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            continue
        out.append(SourceFile(ap, rel, text))
    return out


def all_checkers() -> List[Checker]:
    """The ported rule set (import here, not at module top, so core
    stays importable from checker modules)."""
    from tpufw_torch.analysis.envreg import EnvRegistryChecker
    from tpufw_torch.analysis.hotloop import HotLoopPurityChecker
    from tpufw_torch.analysis.locks import LockDisciplineChecker
    from tpufw_torch.analysis.obsnames import ObsNameChecker

    return [
        HotLoopPurityChecker(),
        EnvRegistryChecker(),
        ObsNameChecker(),
        LockDisciplineChecker(),
    ]


def check_layer(layer: str) -> None:
    """Raise ValueError unless ``layer`` is one the port runs."""
    if layer in UNPORTED_LAYERS:
        raise ValueError(f"layer {layer!r} is {UNPORTED_LAYERS[layer]}")
    if layer not in LAYERS:
        raise ValueError(f"unknown layer {layer!r}; choose from {LAYERS}")


def run_analysis(
    paths: Sequence[str],
    root: Optional[str] = None,
    rules: Optional[Iterable[str]] = None,
    checkers: Optional[Sequence[Checker]] = None,
    layer: str = "all",
) -> List[Finding]:
    """Parse ``paths``, run the (optionally filtered) checker set, and
    return suppression-filtered findings sorted by location. Parse
    failures surface as TPU000 errors rather than crashing the run.
    A layer the port does not run raises ValueError."""
    check_layer(layer)
    root = root or find_repo_root(paths[0] if paths else ".")
    files = collect_files(paths, root)
    project = Project(files, root)
    checkers = list(checkers if checkers is not None else all_checkers())
    if rules is not None:
        want = set(rules)
        unknown = want - {c.rule for c in checkers}
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        checkers = [c for c in checkers if c.rule in want]
    if layer != "all":
        checkers = [c for c in checkers if c.layer == layer]
    findings: List[Finding] = []
    for f in files:
        if f.parse_error is not None:
            findings.append(
                Finding(
                    rule="TPU000",
                    path=f.relpath,
                    line=f.parse_error.lineno or 1,
                    col=(f.parse_error.offset or 0) + 1,
                    message=f"syntax error: {f.parse_error.msg}",
                    severity="error",
                    symbol="syntax-error",
                )
            )
    for checker in checkers:
        for finding in checker.check(project):
            if project.is_suppressed(
                finding.rule, finding.path, finding.line
            ):
                continue
            findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------- baseline

BASELINE_VERSION = 1


def load_baseline(path: str) -> Set[str]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {data.get('version')!r}"
        )
    return set(data.get("findings", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    keys = sorted({f.key() for f in findings})
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    data = {
        "version": BASELINE_VERSION,
        "comment": (
            "tpulint ratchet: findings listed here predate the rule and "
            "are tolerated; new findings fail. This file may only "
            "shrink — fix or inline-suppress (with justification) "
            "instead of adding entries."
        ),
        "rule_counts": dict(sorted(counts.items())),
        "findings": keys,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=False)
        fh.write("\n")


def split_by_baseline(
    findings: Sequence[Finding], baseline: Set[str]
) -> tuple[List[Finding], List[Finding], Set[str]]:
    """(new, baselined, stale_keys): ``new`` fails the run, ``stale``
    are baseline entries no longer observed (the ratchet should
    shrink — rewrite the baseline to drop them)."""
    new: List[Finding] = []
    old: List[Finding] = []
    seen: Set[str] = set()
    for f in findings:
        k = f.key()
        if k in baseline:
            old.append(f)
            seen.add(k)
        else:
            new.append(f)
    return new, old, baseline - seen
