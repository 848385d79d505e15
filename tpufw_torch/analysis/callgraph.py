"""Shared AST infrastructure for the port's tpulint checkers (port of
``tpufw.analysis.callgraph``): a project-wide function index, best-effort
name resolution (imports, module-level string constants), traced-root
discovery for torch's tracers, and a conservative reachability walk.

Resolution is deliberately heuristic — no type inference, no dynamic
dispatch. Calls resolve by (a) same-module definitions, (b) explicit
``from X import name`` / ``import X as y`` bindings, (c) ``self.m``
to a method named ``m`` in the same file. Anything else is skipped,
which biases the suite toward false negatives over false positives:
a lint that cries wolf gets suppressed wholesale and then catches
nothing.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

from tpufw_torch.analysis.core import Project, SourceFile

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


def module_name(relpath: str) -> str:
    """tpufw_torch/train/trainer.py -> tpufw_torch.train.trainer (best
    effort)."""
    p = relpath.replace(os.sep, "/")
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``torch.cuda.synchronize`` -> ["torch", "cuda", "synchronize"];
    None if the chain bottoms out in anything but a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """Last segment of the callee (``torch.compile`` -> "compile")."""
    chain = attr_chain(node.func)
    return chain[-1] if chain else None


class FunctionInfo:
    def __init__(self, qname: str, node: FuncNode, file: SourceFile):
        self.qname = qname
        self.node = node
        self.file = file
        self.module = module_name(file.relpath)

    @property
    def name(self) -> str:
        return self.qname.rsplit(".", 1)[-1]


class ModuleIndex:
    """Project-wide indexes: functions (incl. nested + methods),
    per-module import maps, and module-level string constants."""

    def __init__(self, project: Project):
        self.project = project
        self.functions: List[FunctionInfo] = []
        self.by_module_qname: Dict[Tuple[str, str], FunctionInfo] = {}
        self.by_simple_name: Dict[str, List[FunctionInfo]] = {}
        # module -> local binding -> (source_module, original_name|None)
        self.imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        # module-level NAME = "literal" string constants
        self.constants: Dict[Tuple[str, str], str] = {}
        self.constants_by_name: Dict[str, Set[str]] = {}
        for f in project.files:
            if f.tree is None:
                continue
            self._index_file(f)

    def _index_file(self, f: SourceFile) -> None:
        mod = module_name(f.relpath)
        imps: Dict[str, Tuple[str, Optional[str]]] = {}
        self.imports[mod] = imps

        def walk(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    info = FunctionInfo(q, child, f)
                    self.functions.append(info)
                    self.by_module_qname[(mod, q)] = info
                    self.by_simple_name.setdefault(child.name, []).append(
                        info
                    )
                    walk(child, q)
                elif isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    walk(child, q)
                else:
                    walk(child, prefix)

        walk(f.tree, "")
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    imps[local] = (alias.name, None)
            elif isinstance(node, ast.ImportFrom) and node.module:
                src = node.module
                if node.level:  # relative import: anchor at this package
                    pkg = mod.rsplit(".", node.level)[0]
                    src = f"{pkg}.{node.module}" if pkg else node.module
                for alias in node.names:
                    local = alias.asname or alias.name
                    imps[local] = (src, alias.name)
        for stmt in f.tree.body:
            targets: List[ast.expr] = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
                value = stmt.value
            else:
                continue
            if not (
                isinstance(value, ast.Constant)
                and isinstance(value.value, str)
            ):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    self.constants[(mod, t.id)] = value.value
                    self.constants_by_name.setdefault(t.id, set()).add(
                        value.value
                    )

    # ------------------------------------------------------- resolution

    def resolve_str(
        self, node: ast.AST, module: Optional[str] = None
    ) -> Optional[str]:
        """Literal string, or a Name/Attribute resolving to a
        module-level string constant (same module first, then a
        project-wide unique name match)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        name: Optional[str] = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name is None:
            return None
        if module is not None:
            v = self.constants.get((module, name))
            if v is not None:
                return v
            imp = self.imports.get(module, {}).get(name)
            if imp is not None and imp[1] is not None:
                v = self.constants.get((imp[0], imp[1]))
                if v is not None:
                    return v
        vals = self.constants_by_name.get(name, set())
        if len(vals) == 1:
            return next(iter(vals))
        return None

    def resolve_call(
        self, call: ast.Call, module: str, within: Optional[str] = None
    ) -> Optional[FunctionInfo]:
        """Best-effort: the FunctionInfo a call lands in."""
        func = call.func
        if isinstance(func, ast.Name):
            return self._resolve_name(func.id, module, within)
        if isinstance(func, ast.Attribute):
            chain = attr_chain(func)
            if chain is None:
                return None
            if chain[0] == "self":
                # self.m() -> any method named m in the same file
                # (single-class files dominate; ambiguity -> skip).
                cands = [
                    fi
                    for fi in self.by_simple_name.get(chain[-1], [])
                    if fi.module == module and "." in fi.qname
                ]
                return cands[0] if len(cands) == 1 else None
            imp = self.imports.get(module, {}).get(chain[0])
            if imp is not None and imp[1] is None:
                # `import tpufw_torch.ops.flash as fl; fl.attention(...)`
                return self.by_module_qname.get((imp[0], chain[-1]))
        return None

    def _resolve_name(
        self, name: str, module: str, within: Optional[str]
    ) -> Optional[FunctionInfo]:
        if within:
            # Nested defs: inner-most enclosing scope wins.
            parts = within.split(".")
            for i in range(len(parts), 0, -1):
                q = ".".join([*parts[:i], name])
                fi = self.by_module_qname.get((module, q))
                if fi is not None:
                    return fi
        fi = self.by_module_qname.get((module, name))
        if fi is not None:
            return fi
        imp = self.imports.get(module, {}).get(name)
        if imp is not None and imp[1] is not None:
            return self.by_module_qname.get((imp[0], imp[1]))
        return None


# ---------------------------------------------------------- traced roots

# Callables that trace (or capture) their function argument, by the
# dotted name's last segments: torch.compile, TorchScript, and CUDA-graph
# capture through make_graphed_callables.
_TRACERS = (
    ("torch", "compile"),
    ("jit", "script"),
    ("jit", "trace"),
    ("cuda", "make_graphed_callables"),
)
# Context managers whose body is captured into a CUDA graph.
_CAPTURES = (("cuda", "graph"), ("graphs", "graph"))


def _full_chain(
    index: ModuleIndex, mod: str, chain: Optional[List[str]]
) -> Optional[List[str]]:
    """``chain`` with its first name expanded through the module's
    imports (``from torch.jit import script`` makes ``script`` read as
    ``torch.jit.script``)."""
    if not chain:
        return chain
    imp = index.imports.get(mod, {}).get(chain[0])
    if imp is None:
        return chain
    head = imp[0].split(".") + ([imp[1]] if imp[1] is not None else [])
    return head + chain[1:]


def _ends_with(chain: Optional[List[str]], tails) -> Optional[str]:
    """The matched tail, dotted, when ``chain`` ends with one of
    ``tails``."""
    if not chain:
        return None
    for tail in tails:
        if tuple(chain[-len(tail):]) == tail:
            return ".".join(tail)
    return None


def _first_traced_arg(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in ("model", "fn", "obj", "func", "callables"):
            return kw.value
    return None


def _unwrap_partial(node: ast.AST) -> ast.AST:
    while (
        isinstance(node, ast.Call)
        and call_name(node) in ("partial", "wraps")
        and node.args
    ):
        node = node.args[0]
    return node


def _capture_bodies(f: SourceFile) -> List[Tuple[ast.AST, str]]:
    """(with-statement, enclosing qname) for every ``with
    torch.cuda.graph(...)`` block in ``f``."""
    out: List[Tuple[ast.AST, str]] = []

    def visit(node: ast.AST, qname: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                visit(child, f"{qname}.{child.name}" if qname else child.name)
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and _ends_with(
                        attr_chain(ctx.func), _CAPTURES
                    ):
                        out.append((child, qname))
                        break
            visit(child, qname)

    if f.tree is not None:
        visit(f.tree, "")
    return out


def find_traced_roots(
    index: ModuleIndex, files: Sequence[SourceFile]
) -> List[Tuple[FunctionInfo, str]]:
    """(function, how) pairs for every function handed to
    ``torch.compile``/``torch.jit.script``/``torch.jit.trace``/
    ``torch.cuda.make_graphed_callables`` — via call or decorator — in
    the given files, plus the body of every ``with torch.cuda.graph(g):``
    capture (a synthetic function named ``<cuda.graph>`` inside its
    enclosing function). Lambdas traced inline are returned as synthetic
    FunctionInfo objects."""
    roots: List[Tuple[FunctionInfo, str]] = []
    seen: Set[int] = set()

    def add(fi: Optional[FunctionInfo], how: str) -> None:
        if fi is not None and id(fi.node) not in seen:
            seen.add(id(fi.node))
            roots.append((fi, how))

    for f in files:
        if f.tree is None:
            continue
        mod = module_name(f.relpath)

        def tracer(node: Optional[ast.AST]) -> Optional[str]:
            chain = attr_chain(node) if node is not None else None
            return _ends_with(_full_chain(index, mod, chain), _TRACERS)

        # Decorators.
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call) and call_name(dec) in (
                        "partial",
                    ):
                        # @partial(torch.compile, ...) — the tracer is
                        # partial's first argument.
                        how = tracer(dec.args[0] if dec.args else None)
                    else:
                        target = (
                            dec.func if isinstance(dec, ast.Call) else dec
                        )
                        how = tracer(_unwrap_partial(target))
                    if how:
                        add(_fi_for(index, mod, node, f), f"@{how}")
            if isinstance(node, ast.Call):
                how = tracer(node.func)
                if not how:
                    continue
                arg = _first_traced_arg(node)
                if arg is None:
                    continue
                arg = _unwrap_partial(arg)
                if isinstance(arg, ast.Lambda):
                    add(
                        FunctionInfo("<lambda>", arg, f),
                        f"{how}(<lambda>)",
                    )
                elif isinstance(arg, (ast.Name, ast.Attribute)):
                    fake = ast.Call(func=arg, args=[], keywords=[])
                    ast.copy_location(fake, arg)
                    add(index.resolve_call(fake, mod), f"{how}()")
        # CUDA-graph capture blocks.
        for with_node, qname in _capture_bodies(f):
            body = ast.FunctionDef(
                name="<cuda.graph>",
                args=ast.arguments(
                    posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                    kw_defaults=[], kwarg=None, defaults=[],
                ),
                body=with_node.body,
                decorator_list=[],
                returns=None,
            )
            ast.copy_location(body, with_node)
            q = f"{qname}.<cuda.graph>" if qname else "<cuda.graph>"
            add(FunctionInfo(q, body, f), "with cuda.graph")
    return roots


def _fi_for(
    index: ModuleIndex, mod: str, node: ast.AST, f: SourceFile
) -> Optional[FunctionInfo]:
    for fi in index.by_simple_name.get(getattr(node, "name", ""), []):
        if fi.node is node:
            return fi
    return None


def reachable_functions(
    index: ModuleIndex,
    roots: Sequence[Tuple[FunctionInfo, str]],
    max_depth: int = 8,
) -> Dict[int, Tuple[FunctionInfo, str]]:
    """BFS the call graph from the traced roots. Returns
    ``id(node) -> (FunctionInfo, chain-description)``. Expansion is
    bounded by the scan set: ``resolve_call`` only knows functions
    defined in scanned files, so torch internals never enter."""
    out: Dict[int, Tuple[FunctionInfo, str]] = {}
    frontier: List[Tuple[FunctionInfo, str, int]] = [
        (fi, how, 0) for fi, how in roots
    ]
    while frontier:
        fi, how, depth = frontier.pop()
        if id(fi.node) in out:
            continue
        out[id(fi.node)] = (fi, how)
        if depth >= max_depth:
            continue
        for call in iter_calls(fi.node):
            callee = index.resolve_call(
                call, fi.module, within=fi.qname
            )
            if callee is None or id(callee.node) in out:
                continue
            frontier.append(
                (callee, f"{how} -> {callee.name}", depth + 1)
            )
    return out


def iter_calls(fn: FuncNode) -> Iterator[ast.Call]:
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                yield node
