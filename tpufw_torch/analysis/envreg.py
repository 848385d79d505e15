"""TPU004 — TPUFW_* environment-variable registry hygiene (port of
``tpufw.analysis.envreg``).

The manifest-is-the-config contract (YAML manifest -> env ->
dataclass) only holds if every ``TPUFW_*`` knob goes through one choke
point: the typed helpers in ``tpufw_torch/workloads/env.py``. A raw
``os.environ.get("TPUFW_...")`` bypasses the type discipline (bool
parsing, empty-string-means-off) and — worse — invents knobs no
manifest author can discover. The rule:

- every ``TPUFW_*`` read must round-trip through the env.py helpers
  (direct ``environ.get`` / ``getenv`` / subscript / ``in`` reads are
  flagged);
- every ``TPUFW_*`` name appearing in code must be documented in
  ``docs/torch/ENV.md`` (the port's catalog) or another of the port's
  doc pages;
- names documented in ``docs/torch/ENV.md`` but absent from code are
  stale (warning);
- near-identical name pairs (edit distance 1) are probable typos
  (warning).

Writes (``os.environ["TPUFW_X"] = ...`` for subprocess setup, the
autotuner's set/restore dance) are not reads and are not flagged.

The port's catalog lists the knobs the port's code reads, so unlike
``tpufw``'s rule a name mentioned only under ``deploy/`` (``tpufw``'s
manifests) does not keep a catalog entry alive.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Tuple

from tpufw_torch.analysis import callgraph as cg
from tpufw_torch.analysis.core import (
    ENV_CATALOG_DOC,
    Checker,
    Finding,
    Project,
    SourceFile,
)

ENV_HELPERS = {
    "env_str",
    "env_int",
    "env_float",
    "env_bool",
    "env_opt_int",
    "env_opt_str",
}
ENV_MODULE = "tpufw_torch/workloads/env.py"
# Doc-page parsing is single-sourced in core.load_env_catalog;
# CATALOG_DOC is the name findings point at.
CATALOG_DOC = ENV_CATALOG_DOC

_NAME_RE = re.compile(r"^TPUFW_[A-Z0-9_]+$")

# Receiver names that look like an environment mapping.
_ENVISH = {"environ", "env", "_env"}

# Name pairs at edit distance 1 that are genuinely distinct knobs,
# not typos. Extend deliberately; each entry should be obvious.
_NEAR_DUP_OK = {
    frozenset({"TPUFW_TOP_K", "TPUFW_TOP_P"}),
}


def _is_envish(node: ast.AST) -> bool:
    chain = cg.attr_chain(node)
    if chain is None:
        return False
    return bool(set(chain) & _ENVISH) or chain[-1] in ("getenv",)


def _edit_distance_1(a: str, b: str) -> bool:
    if a == b or abs(len(a) - len(b)) > 1:
        return False
    if len(a) > len(b):
        a, b = b, a
    if len(a) == len(b):
        return sum(x != y for x, y in zip(a, b)) == 1
    for i in range(len(b)):
        if a == b[:i] + b[i + 1:]:
            return True
    return False


class EnvRegistryChecker(Checker):
    rule = "TPU004"
    name = "env-var-registry"
    severity = "error"

    def check(self, project: Project) -> Iterator[Finding]:
        registered: Dict[str, Tuple[SourceFile, ast.AST]] = {}
        direct_reads: List[Tuple[SourceFile, ast.AST, str]] = []
        mentioned: Dict[str, Tuple[SourceFile, ast.AST]] = {}

        for f in project.files:
            if f.tree is None:
                continue
            is_env_module = f.relpath == ENV_MODULE
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Call):
                    name = cg.call_name(node)
                    if name in ENV_HELPERS and node.args:
                        a0 = node.args[0]
                        if isinstance(a0, ast.Constant) and isinstance(
                            a0.value, str
                        ):
                            full = "TPUFW_" + a0.value.upper()
                            registered.setdefault(full, (f, a0))
                            mentioned.setdefault(full, (f, a0))
                        continue
                    # environ.get("TPUFW_X") / os.getenv("TPUFW_X")
                    if (
                        name in ("get", "getenv", "pop", "setdefault")
                        and _is_envish(node.func)
                        and node.args
                    ):
                        lit = self._tpufw_literal(node.args[0])
                        if lit and not is_env_module:
                            kind = (
                                "read"
                                if name in ("get", "getenv")
                                else name
                            )
                            if kind == "read":
                                direct_reads.append((f, node, lit))
                            mentioned.setdefault(lit, (f, node))
                elif isinstance(node, ast.Subscript) and _is_envish(
                    node.value
                ):
                    lit = self._tpufw_literal(node.slice)
                    if lit:
                        mentioned.setdefault(lit, (f, node))
                        if isinstance(
                            node.ctx, ast.Load
                        ) and not is_env_module:
                            direct_reads.append((f, node, lit))
                elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn))
                    for op in node.ops
                ):
                    lit = self._tpufw_literal(node.left)
                    if (
                        lit
                        and node.comparators
                        and _is_envish(node.comparators[0])
                    ):
                        mentioned.setdefault(lit, (f, node))
                        if not is_env_module:
                            direct_reads.append((f, node, lit))
                elif isinstance(node, ast.Constant) and isinstance(
                    node.value, str
                ):
                    if _NAME_RE.match(node.value):
                        mentioned.setdefault(node.value, (f, node))

        for f, node, lit in direct_reads:
            yield self.finding(
                f,
                node,
                f"direct environment read of {lit!r} bypasses the "
                "typed tpufw_torch.workloads.env helpers (env_str/env_int/"
                "env_bool/...) — route it through the registry or "
                "suppress with a justification",
                symbol=f"direct-read:{lit}",
            )

        catalog = project.env_catalog()
        for name in sorted(mentioned):
            if name not in catalog.doc_names:
                f, node = mentioned[name]
                yield self.finding(
                    f,
                    node,
                    f"{name} is not documented in {CATALOG_DOC} (or "
                    "any doc page) — every env knob must be "
                    "discoverable by a manifest author",
                    symbol=f"undocumented:{name}",
                )
        # "Stale" = cataloged but not used in the scanned code.
        for name in sorted(catalog.catalog_names - set(mentioned)):
            yield Finding(
                rule=self.rule,
                path=CATALOG_DOC,
                line=1,
                col=1,
                message=(
                    f"{name} is documented in {CATALOG_DOC} but no "
                    "longer appears in code — stale catalog entry"
                ),
                severity="warning",
                symbol=f"stale-doc:{name}",
            )

        names = sorted(mentioned)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if frozenset({a, b}) in _NEAR_DUP_OK:
                    continue
                if _edit_distance_1(a, b):
                    f, node = mentioned[b]
                    yield self.finding(
                        f,
                        node,
                        f"{b} is one edit away from {a} — probable "
                        "typo'd duplicate knob",
                        symbol=f"near-duplicate:{a}~{b}",
                        severity="warning",
                    )

    @staticmethod
    def _tpufw_literal(node: ast.AST) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if _NAME_RE.match(node.value):
                return node.value
        return None
