"""The port's own tree under the port's lint: clean under the python layer
against the empty baseline, the knob catalog equal to the knobs the code
reads, every suppression justified, and the lint importable without torch
or JAX (a bare CI container runs it)."""

import ast
import io
import json
import os
import re
import subprocess
import sys
import tokenize

from tests.torch_lint import ROOT
from tpufw_torch.analysis import core
from tpufw_torch.analysis.__main__ import _default_paths
from tpufw_torch.analysis.envreg import ENV_HELPERS

BASELINE = os.path.join(ROOT, "tpufw_torch", "analysis", "baseline.json")


def test_live_tree_clean_against_the_empty_baseline():
    """The port's code lints clean under the python layer, and the
    baseline that could tolerate a finding is empty."""
    with open(BASELINE) as fh:
        assert json.load(fh)["findings"] == []
    assert core.load_baseline(BASELINE) == set()
    paths = _default_paths(ROOT)
    assert os.path.join(ROOT, "tpufw_torch") in paths
    assert os.path.join(ROOT, "chip_smoke.py") in paths
    findings = core.run_analysis(paths, root=ROOT, layer="python")
    assert findings == [], "\n".join(f.render() for f in findings)


def test_cli_on_the_package_exits_0():
    res = subprocess.run(
        [sys.executable, "-m", "tpufw_torch.analysis", "--layer", "python",
         "tpufw_torch"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "tpulint: clean (0 finding(s) total, 0 baselined)" in res.stdout


def _knobs_read(paths):
    """Every TPUFW_* name the scanned code names: helper reads and
    literal strings (the names TPU004 checks)."""
    names = set()
    for f in core.collect_files(paths, ROOT):
        for node in ast.walk(f.tree):
            if (isinstance(node, ast.Call) and node.args
                    and getattr(node.func, "attr",
                                getattr(node.func, "id", None)) in ENV_HELPERS
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names.add("TPUFW_" + node.args[0].value.upper())
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and re.fullmatch(r"TPUFW_[A-Z0-9_]+", node.value)):
                names.add(node.value)
    return names


def test_knob_catalog_is_the_knobs_the_port_reads():
    """docs/torch/ENV.md has one typed row for each knob the package
    reads (the smoke, validate and lint knobs and TPUFW_DEVICE among
    them) and none other."""
    project = core.Project([], ROOT)
    cat = project.env_catalog()
    read = _knobs_read([os.path.join(ROOT, "tpufw_torch")])
    assert set(cat.entries) == read
    assert cat.catalog_names == read
    for knob in ("TPUFW_DEVICE", "TPUFW_SMOKE_MATMUL_DIM",
                 "TPUFW_SMOKE_MATMUL_REPS", "TPUFW_VALIDATE_REQUIRE_JAX",
                 "TPUFW_LINT_LAYERS"):
        assert knob in cat.entries, knob
    types = {"int", "float", "str", "bool", "opt int", "opt str",
             "bool/int"}
    assert {e.type for e in cat.entries.values()} <= types


def test_every_suppression_carries_a_justification():
    """A ``# tpulint: disable`` in the port's code names its rules and
    then says why, on its line or the comment lines under it."""
    pat = re.compile(r"#\s*tpulint:\s*disable(?:-file)?\s*=\s*"
                     r"[A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*(.*)$")
    seen = 0
    for f in core.collect_files(_default_paths(ROOT), ROOT):
        tokens = tokenize.generate_tokens(io.StringIO(f.text).readline)
        for tok in tokens:
            m = pat.match(tok.string) if tok.type == tokenize.COMMENT else None
            if not m:
                continue
            seen += 1
            i = tok.start[0]  # 1-based: f.lines[i] is the next line
            why = m.group(1).strip(" —-:")
            if not why and i < len(f.lines):
                why = f.lines[i].strip().lstrip("#").strip()
            assert len(why) > 15, f"{f.relpath}:{i}: {tok.string}"
    assert seen >= 2  # cluster/bootstrap.py, cluster/discovery.py


def test_lint_imports_no_torch_or_jax():
    """Importing the CLI and every rule loads neither torch, JAX, numpy
    nor anything of tpufw — the stdlib-only rule tpufw's lint keeps."""
    code = (
        "import sys\n"
        "import tpufw_torch.analysis.__main__\n"
        "from tpufw_torch.analysis import core, sarif\n"
        "core.all_checkers()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'numpy', 'flax', 'tpufw'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=60, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", (
        res.stdout + res.stderr)


def test_analysis_modules_import_only_the_stdlib_and_themselves():
    pkg = os.path.join(ROOT, "tpufw_torch", "analysis")
    for fn in sorted(os.listdir(pkg)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(pkg, fn)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                assert top == "tpufw_torch" or top in sys.stdlib_module_names, (
                    fn, m)
                if top == "tpufw_torch":
                    assert m.startswith(("tpufw_torch.analysis",
                                         "tpufw_torch.workloads.env")), (fn, m)
