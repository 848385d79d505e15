"""Shared set-up of the port's lint tests (``tests/test_torch_analysis_*``):
fixture trees under ``tmp_path`` linted by the port's ``run_analysis``,
and the same tree written in each package's layout for parity with
``tpufw.analysis``. Stdlib only, like the lint."""

import os

from tpufw_torch.analysis.core import run_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Where each package keeps what the rules read: the env helpers, the
# event schema, and the two catalogs.
LAYOUTS = {
    "tpufw": {"pkg": "tpufw", "docs": "docs"},
    "tpufw_torch": {"pkg": "tpufw_torch", "docs": "docs/torch"},
}


def write_tree(base, files):
    for rel, text in files.items():
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def run_fixture(tmp_path, files, rules=None, layer="all"):
    """Write ``files`` (relpath -> source) under tmp_path and lint with
    the port's rules."""
    write_tree(tmp_path, files)
    return run_analysis([str(tmp_path)], root=str(tmp_path), rules=rules,
                        layer=layer)


def keys(findings):
    return [f.symbol for f in findings]


def in_layout(files, package):
    """``files`` with ``{pkg}``/``{docs}`` in paths and sources filled
    for ``package``."""
    lay = LAYOUTS[package]
    return {rel.format(**lay): text.replace("{pkg}", lay["pkg"])
            for rel, text in files.items()}


def normalized(findings, package):
    """(rule, path after the package's prefix, line, symbol) of each
    finding: ``tpufw/x.py`` and ``tpufw_torch/x.py`` both read ``x.py``,
    ``docs/ENV.md`` and ``docs/torch/ENV.md`` both ``ENV.md``."""
    lay = LAYOUTS[package]
    out = []
    for f in findings:
        path = f.path
        for prefix in (lay["pkg"] + "/", lay["docs"] + "/"):
            if path.startswith(prefix):
                path = path[len(prefix):]
                break
        out.append((f.rule, path, f.line, f.symbol))
    return sorted(out)


def parity(tmp_path, files, rule):
    """The findings of ``rule`` on ``files`` written in each package's
    layout, through ``tpufw``'s checker and the port's, normalized."""
    from tpufw.analysis.core import run_analysis as tpufw_run

    out = {}
    for package, run in (("tpufw", tpufw_run), ("tpufw_torch", run_analysis)):
        base = tmp_path / package
        write_tree(base, in_layout(files, package))
        found = run([str(base)], root=str(base), rules=[rule],
                    layer="python")
        out[package] = normalized(found, package)
    return out["tpufw"], out["tpufw_torch"]
