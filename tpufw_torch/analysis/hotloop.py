"""TPU001 — hot-loop purity (port of ``tpufw.analysis.hotloop``).

Two scopes, one rule: code that torch traces or captures
(``torch.compile``, ``torch.jit.script``/``trace``, a CUDA-graph
capture) must never touch the host (``.item()``, ``.cpu()``,
``np.asarray``, ``torch.cuda.synchronize``, I/O) — a graph break or a
capture error at best, a device->host round trip per step at worst; and
the *host-side step loop* (any function driving batches through the
step via ``timed_batches``) must keep its per-step path free of the same
sync primitives, because one stray ``.item()`` drains the CUDA stream
the next step's launches should be queued behind.

Intentional sync points are allowlisted by receiver: the ``Meter``
(whose ``float(loss)`` IS the designed once-per-window barrier), the
``SkewMonitor`` (rides that same window), and telemetry/checkpoint
handles. Anything else needs a ``# tpulint: disable=TPU001`` with a
justification.

torch's sync primitives take the place of jax's (``block_until_ready``,
``jax.device_get``): ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``.to("cpu")``, and ``.synchronize()`` on any receiver
(``torch.cuda.synchronize``, a stream's, an event's).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from tpufw_torch.analysis import callgraph as cg
from tpufw_torch.analysis.core import Checker, Finding, Project

# Receiver base names whose method calls are designed sync points in
# the host loop (Meter.stop's float(loss) barrier, skew allgather,
# telemetry emit/span, checkpoint save/wait, profiler, preemption).
HOST_LOOP_ALLOWED_RECEIVERS: Set[str] = {
    "meter",
    "skew",
    "tel",
    "telemetry",
    "tracer",
    "events",
    "prof",
    "profiler",
    "ckpt",
    "shutdown",
}

_NP_ALIASES = {"np", "numpy", "onp"}

# Plain-call names that are host I/O wherever they appear in a hot path.
_IO_CALLS = {"print", "open", "input", "breakpoint"}


def _sync_reason(node: ast.Call) -> Optional[Tuple[str, str]]:
    """(symbol, reason) when ``node`` is a host-sync primitive."""
    func = node.func
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr == "item" and not node.args:
            return (".item()", ".item() forces a device->host sync")
        if attr in ("tolist", "cpu", "numpy") and not node.args:
            return (
                f".{attr}()",
                f".{attr}() copies the tensor to the host and waits "
                "for the device",
            )
        if attr == "to" and _to_cpu(node):
            return (".to(cpu)", ".to('cpu') copies the tensor to the host")
        if attr == "synchronize":
            return (
                "synchronize",
                "synchronize blocks the host on the device",
            )
        if attr in ("asarray", "array"):
            base = func.value
            if isinstance(base, ast.Name) and base.id in _NP_ALIASES:
                return (
                    f"np.{attr}",
                    f"np.{attr} materializes the array on host "
                    "(keep tensors on the device inside traced/step code)",
                )
        if attr == "sleep":
            base = func.value
            if isinstance(base, ast.Name) and base.id == "time":
                return ("time.sleep", "host sleep in a hot path")
    elif isinstance(func, ast.Name):
        if func.id in _IO_CALLS:
            return (func.id, f"host I/O call {func.id}()")
    return None


def _to_cpu(node: ast.Call) -> bool:
    """``t.to("cpu")`` / ``t.to(device="cpu")`` (a literal device)."""
    args = list(node.args[:1]) + [
        kw.value for kw in node.keywords if kw.arg == "device"
    ]
    return any(
        isinstance(a, ast.Constant) and a.value == "cpu" for a in args
    )


def _float_int_of_traced(
    node: ast.Call, params: Set[str]
) -> Optional[Tuple[str, str]]:
    """float()/int() applied to something that is an array in traced
    code: a subscript (``m[\"loss\"]``) or a function parameter. Both
    heuristics; plain float(literal) math is never flagged."""
    func = node.func
    if not (isinstance(func, ast.Name) and func.id in ("float", "int")):
        return None
    if len(node.args) != 1:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Subscript):
        return (
            f"{func.id}(subscript)",
            f"{func.id}() on a subscripted value forces a host sync",
        )
    if isinstance(arg, ast.Name) and arg.id in params:
        return (
            f"{func.id}({arg.id})",
            f"{func.id}() on parameter {arg.id!r} forces a host sync",
        )
    return None


def _float_int_host(node: ast.Call) -> Optional[Tuple[str, str]]:
    """float()/int() on a local name or subscript inside the step
    loop — the classic one-liner that serializes async dispatch
    (``loss_f = float(loss)``). Literal/expression args are skipped."""
    func = node.func
    if not (isinstance(func, ast.Name) and func.id in ("float", "int")):
        return None
    if len(node.args) != 1:
        return None
    arg = node.args[0]
    if isinstance(arg, (ast.Name, ast.Subscript)):
        what = arg.id if isinstance(arg, ast.Name) else "subscript"
        return (
            f"{func.id}({what})",
            f"{func.id}() on {what!r} forces a device->host sync",
        )
    return None


def _fn_params(fn: cg.FuncNode) -> Set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _receiver_base(node: ast.AST) -> Optional[str]:
    """meter.stop -> "meter"; self.telemetry.close -> "telemetry";
    tel.events.emit -> "tel"."""
    chain = cg.attr_chain(node)
    if not chain:
        return None
    if chain[0] == "self" and len(chain) > 2:
        return chain[1]
    return chain[0]


class HotLoopPurityChecker(Checker):
    rule = "TPU001"
    name = "hot-loop-purity"
    severity = "error"

    def check(self, project: Project) -> Iterator[Finding]:
        index = cg.ModuleIndex(project)
        yield from self._check_traced(project, index)
        yield from self._check_host_loops(project, index)

    # -------------------------------------------------- traced scope

    def _check_traced(
        self, project: Project, index: cg.ModuleIndex
    ) -> Iterator[Finding]:
        roots = cg.find_traced_roots(index, project.files)
        reach = cg.reachable_functions(index, roots)
        for fi, how in reach.values():
            params = _fn_params(fi.node)
            for call in cg.iter_calls(fi.node):
                hit = _sync_reason(call) or _float_int_of_traced(
                    call, params
                )
                if hit is None:
                    continue
                symbol, reason = hit
                yield self.finding(
                    fi.file,
                    call,
                    f"{reason} inside traced function "
                    f"{fi.qname!r} (traced via {how})",
                    symbol=f"traced:{fi.qname}:{symbol}",
                )

    # ------------------------------------------------ host-loop scope

    def _check_host_loops(
        self, project: Project, index: cg.ModuleIndex
    ) -> Iterator[Finding]:
        for f in project.files:
            if f.tree is None:
                continue
            mod = cg.module_name(f.relpath)
            for fi in index.functions:
                if fi.file is not f:
                    continue
                if not self._is_step_loop_driver(fi.node):
                    continue
                for loop in self._loops(fi.node):
                    yield from self._scan_host_scope(
                        f, index, mod, fi, loop.body, hops=1
                    )

    @staticmethod
    def _is_step_loop_driver(fn: cg.FuncNode) -> bool:
        """A function that iterates ``timed_batches(...)`` — the one
        marked entrypoint all the port's step loops share
        (``tpufw_torch.train.metrics.timed_batches``)."""
        for call in cg.iter_calls(fn):
            if cg.call_name(call) == "timed_batches":
                return True
        return False

    @staticmethod
    def _loops(fn: cg.FuncNode) -> List[ast.stmt]:
        out = []
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.For, ast.While)):
                    out.append(node)
        return out

    def _scan_host_scope(
        self,
        f,
        index: cg.ModuleIndex,
        mod: str,
        owner: cg.FunctionInfo,
        body: List[ast.stmt],
        hops: int,
        _visited: Optional[Set[int]] = None,
    ) -> Iterator[Finding]:
        visited = _visited if _visited is not None else set()
        for stmt in body:
            stack: List[ast.AST] = [stmt]
            while stack:
                node = stack.pop()
                if isinstance(node, ast.Call):
                    base = _receiver_base(node.func)
                    if base in HOST_LOOP_ALLOWED_RECEIVERS:
                        # The whole call — arguments included — is the
                        # designed sync point (meter.stop(float(loss)),
                        # tel.events.emit(..., float(v), ...)).
                        continue
                stack.extend(ast.iter_child_nodes(node))
                if not isinstance(node, ast.Call):
                    continue
                hit = _sync_reason(node) or _float_int_host(node)
                if hit is not None:
                    symbol, reason = hit
                    yield self.finding(
                        f,
                        node,
                        f"{reason} in the step loop of "
                        f"{owner.qname!r} — each occurrence "
                        "serializes async dispatch; move it behind "
                        "the sync window or allowlist the receiver",
                        symbol=f"hotloop:{owner.qname}:{symbol}",
                        severity="warning",
                    )
                    continue
                # One hop into helpers defined in the same module
                # (nested closures like record_window).
                if hops > 0 and isinstance(node.func, ast.Name):
                    callee = index.resolve_call(
                        node, mod, within=owner.qname
                    )
                    if (
                        callee is not None
                        and callee.file is f
                        and id(callee.node) not in visited
                    ):
                        visited.add(id(callee.node))
                        cbody = callee.node.body
                        if not isinstance(cbody, list):
                            cbody = [cbody]
                        yield from self._scan_host_scope(
                            f, index, mod, callee, cbody,
                            hops - 1, visited,
                        )
