"""The port's tpulint core (``tpufw_torch.analysis``): parse errors, the
baseline ratchet, the CLI and its exit codes, SARIF, the replay cache and
``--since``, and the layer selection — the mirrors of
``tests/test_analysis.py``'s framework, SARIF, incremental and layer
tests, plus the layers the port does not run (exit 2, naming why)."""

import json
import os
import re
import subprocess

import pytest

from tests.torch_lint import ROOT, keys, run_fixture
from tpufw_torch.analysis import core, incremental, sarif
from tpufw_torch.analysis.__main__ import main
from tpufw_torch.analysis.core import Finding, run_analysis

# One traced-scope TPU001 error: .item() under torch.compile.
TRACED_ITEM = (
    "import torch\n"
    "@torch.compile\n"
    "def step(x):\n"
    "    return x.sum().item()\n"
)
# One host-loop TPU001 warning.
LOOP_CPU = (
    "def run(src, meter, train):\n"
    "    for batch in timed_batches(src, meter):\n"
    "        loss = train(batch)\n"
    "        v = loss.cpu()\n"
)


def _project(tmp_path, text=TRACED_ITEM):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    mod = tmp_path / "mod.py"
    mod.write_text(text)
    return mod


# ------------------------------------------------------------- framework


def test_syntax_error_becomes_tpu000(tmp_path):
    out = run_fixture(tmp_path, {"bad.py": "def f(:\n"})
    assert [f.rule for f in out] == ["TPU000"], out


def test_baseline_roundtrip_and_ratchet(tmp_path):
    findings = run_fixture(tmp_path, {"mod.py": TRACED_ITEM},
                           rules=["TPU001"])
    assert len(findings) == 1
    bl_path = tmp_path / "baseline.json"
    core.write_baseline(str(bl_path), findings)
    baseline = core.load_baseline(str(bl_path))
    new, old, stale = core.split_by_baseline(findings, baseline)
    assert new == [] and len(old) == 1 and stale == set()
    # Fixing the finding leaves a stale entry — the ratchet's shrink
    # signal — and nothing new.
    new, old, stale = core.split_by_baseline([], baseline)
    assert new == [] and old == [] and len(stale) == 1


def test_baseline_version_mismatch_raises(tmp_path):
    p = tmp_path / "bl.json"
    p.write_text(json.dumps({"version": 999, "findings": []}))
    with pytest.raises(ValueError, match="unsupported version"):
        core.load_baseline(str(p))


def test_cli_exit_codes(tmp_path):
    bad = _project(tmp_path)
    assert main([str(bad), "--no-baseline"]) == 1
    bl = tmp_path / "tpufw_torch" / "analysis" / "baseline.json"
    bl.parent.mkdir(parents=True)
    assert main([str(bad), "--write-baseline", str(bl)]) == 0
    # The default baseline (tpufw_torch/analysis/baseline.json under the
    # root found via pyproject.toml) now absorbs the finding.
    assert main([str(bad)]) == 0
    assert main([str(bad), "--no-baseline", "--rules", "TPU004"]) == 0
    assert main([str(bad), "--rules", "TPU003"]) == 2  # not a port rule
    assert main(["--list-rules"]) == 0
    bl.write_text("{not json")
    assert main([str(bad)]) == 2


def test_cli_json_layer_field(tmp_path, capsys):
    mod = _project(tmp_path)
    assert main([str(mod), "--json", "--no-baseline", "--layer",
                 "python"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["rule"]: f["layer"] for f in doc["findings"]} == {
        "TPU001": "python"}
    assert doc["baselined"] == [] and doc["stale_baseline_keys"] == []


def test_cli_list_rules_groups_by_layer(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    block = out.split("layer python:")[1].split("layer ")[0]
    for rule in ("TPU001", "TPU004", "TPU005", "TPU009"):
        assert rule in block, out
    assert "TPU003" not in out
    assert "layer protocol: not ported yet: item 13d(b)" in out
    assert "layer lifetime: not ported yet: item 13d(b)" in out


# ---------------------------------------------------------------- layers


def test_layer_filtering(tmp_path):
    """Every ported rule is in the python layer, so python and all give
    the same findings."""
    files = {"mod.py": TRACED_ITEM, "loop.py": LOOP_CPU}
    py = run_fixture(tmp_path, files, layer="python")
    every = run_fixture(tmp_path, files, layer="all")
    assert {f.rule for f in py} == {"TPU001"}, keys(py)
    assert py == every
    assert core.LAYERS == ("python", "all")
    assert {c.layer for c in core.all_checkers()} == {"python"}


def test_layer_validation():
    with pytest.raises(ValueError, match="unknown layer"):
        run_analysis([], root=".", layer="helm")


@pytest.mark.parametrize("layer", ["protocol", "lifetime", "deploy"])
def test_unported_layer_exits_2(tmp_path, capsys, monkeypatch, layer):
    """A layer of ``tpufw``'s lint that the port does not run is an
    error naming why — from --layer and from TPUFW_LINT_LAYERS — never a
    silent pass."""
    mod = _project(tmp_path, "x = 1\n")
    why = "item 13d(b)" if layer != "deploy" else "tpufw.analysis"
    with pytest.raises(ValueError, match=re.escape(why)):
        run_analysis([str(mod)], root=str(tmp_path), layer=layer)
    monkeypatch.delenv("TPUFW_LINT_LAYERS", raising=False)
    assert main([str(mod), "--no-baseline", "--layer", layer]) == 2
    assert why in capsys.readouterr().err
    monkeypatch.setenv("TPUFW_LINT_LAYERS", f"python,{layer}")
    assert main([str(mod), "--no-baseline"]) == 2
    err = capsys.readouterr().err
    assert "TPUFW_LINT_LAYERS" in err and why in err


def test_cli_env_layer_default(tmp_path, monkeypatch):
    """Without --layer, TPUFW_LINT_LAYERS picks the layers; a typo in
    it is a usage error (exit 2), not a silent full scan."""
    mod = _project(tmp_path, "x = 1\n")
    monkeypatch.setenv("TPUFW_LINT_LAYERS", "python,all")
    assert main([str(mod), "--no-baseline"]) == 0
    monkeypatch.setenv("TPUFW_LINT_LAYERS", "helm")
    assert main([str(mod), "--no-baseline"]) == 2
    monkeypatch.delenv("TPUFW_LINT_LAYERS")
    assert main([str(mod), "--no-baseline"]) == 0
    bad = _project(tmp_path)
    monkeypatch.setenv("TPUFW_LINT_LAYERS", "python,all")
    assert main([str(bad), "--no-baseline"]) == 1


def test_env_catalog_single_source(tmp_path):
    """core.load_env_catalog parses the port's catalog's typed rows
    once; tpufw's docs/ENV.md is not read."""
    (tmp_path / "docs" / "torch").mkdir(parents=True)
    (tmp_path / "docs" / "torch" / "ENV.md").write_text(
        "| Variable | Type | Default | Meaning |\n|---|---|---|---|\n"
        "| `TPUFW_BATCH_SIZE` | int | 256 | global batch rows |\n"
        "| `TPUFW_DEBUG` | bool | false | debug logging |\n")
    (tmp_path / "docs" / "ENV.md").write_text("`TPUFW_OTHER`\n")
    (tmp_path / "docs" / "torch" / "OBSERVABILITY.md").write_text(
        "`TPUFW_TELEMETRY_DIR`\n")
    project = core.Project([], str(tmp_path))
    cat = project.env_catalog()
    assert cat.entries["TPUFW_BATCH_SIZE"].type == "int"
    assert cat.entries["TPUFW_DEBUG"].default == "false"
    assert cat.catalog_names == {"TPUFW_BATCH_SIZE", "TPUFW_DEBUG"}
    assert "TPUFW_TELEMETRY_DIR" in cat.doc_names
    assert "TPUFW_OTHER" not in cat.doc_names
    assert project.env_catalog() is cat  # cached


# ----------------------------------------------------------------- SARIF


def test_sarif_validates_against_schema(tmp_path):
    import jsonschema

    findings = run_fixture(tmp_path, {"mod.py": TRACED_ITEM})
    assert findings, "fixture must produce findings"
    doc = sarif.to_sarif(findings)
    with open(os.path.join(ROOT, "tests", "data",
                           "sarif-2.1.0-core.schema.json")) as fh:
        schema = json.load(fh)
    jsonschema.Draft7Validator.check_schema(schema)
    jsonschema.validate(doc, schema)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "tpulint"
    rule_ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    # The ported rules only.
    assert rule_ids == ["TPU000", "TPU001", "TPU004", "TPU005", "TPU009"]
    res = run["results"][0]
    src = findings[0]
    assert res["ruleId"] == src.rule
    assert res["partialFingerprints"]["tpulintKey/v1"] == src.key()
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == src.path
    assert loc["region"]["startLine"] == src.line


def test_sarif_level_mapping(tmp_path):
    findings = run_fixture(tmp_path, {"loop.py": LOOP_CPU},
                           rules=["TPU001"])
    assert findings and findings[0].severity == "warning"
    assert sarif.to_sarif(findings)["runs"][0]["results"][0][
        "level"] == "warning"


def test_sarif_cli_flag(tmp_path):
    mod = _project(tmp_path)
    out = tmp_path / "out.sarif"
    assert main([str(mod), "--no-baseline", "--sarif", str(out)]) == 1
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    assert len(doc["runs"][0]["results"]) == 1


# ----------------------------------------------------------- incremental


def test_incremental_cache_roundtrip(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("x = 1\n")
    py_files = core.iter_py_files([str(tmp_path)], str(tmp_path))
    sig = incremental.scan_signature(str(tmp_path), py_files, None)
    findings = run_fixture(tmp_path / "fx", {"mod.py": TRACED_ITEM})
    cache = tmp_path / "cache.json"
    incremental.save_cache(str(cache), sig, findings)
    assert incremental.load_cached(str(cache), sig) == findings
    # Any content drift invalidates the signature.
    mod.write_text("x = 2\n")
    py_files = core.iter_py_files([str(tmp_path)], str(tmp_path))
    sig2 = incremental.scan_signature(str(tmp_path), py_files, None)
    assert sig2 != sig
    assert incremental.load_cached(str(cache), sig2) is None
    # A rule-subset change also invalidates.
    assert incremental.scan_signature(
        str(tmp_path), py_files, ["TPU001"]) != sig2


def test_scan_signature_covers_the_port_catalogs(tmp_path):
    """The catalogs the rules read are hashed; tpufw's are not, and no
    deploy/ tree is (the port runs no deploy layer)."""
    (tmp_path / "docs" / "torch").mkdir(parents=True)
    (tmp_path / "deploy").mkdir()
    (tmp_path / "deploy" / "a.yaml").write_text("kind: Pod\n")
    env = tmp_path / "docs" / "torch" / "ENV.md"
    env.write_text("`TPUFW_A`\n")
    sig_a = incremental.scan_signature(str(tmp_path), [], None)
    (tmp_path / "docs" / "ENV.md").write_text("`TPUFW_B`\n")
    assert incremental.scan_signature(str(tmp_path), [], None) == sig_a
    env.write_text("`TPUFW_B`\n")
    sig_b = incremental.scan_signature(str(tmp_path), [], None)
    assert sig_b != sig_a
    assert "deploy" not in sig_b
    assert set(sig_b["docs"]) == {"docs/torch/ENV.md",
                                  "docs/torch/OBSERVABILITY.md"}


def test_incremental_cli_cache_replay(tmp_path, capsys):
    mod = _project(tmp_path)
    cache = tmp_path / ".tpulint_torch_cache.json"
    argv = [str(mod), "--no-baseline", "--cache", str(cache)]
    assert main(argv) == 1
    assert cache.exists()
    capsys.readouterr()
    assert main(argv) == 1  # replay: same exit code
    assert "replayed" in capsys.readouterr().err


def test_since_filter_and_git_gating(tmp_path):
    f1 = Finding("TPU001", "a.py", 1, 1, "m")
    f2 = Finding("TPU001", "b.py", 1, 1, "m")
    assert incremental.filter_since([f1, f2], {"b.py"}) == [f2]
    # Not a git checkout -> None (gate on everything).
    assert incremental.changed_files(str(tmp_path), "HEAD") is None
    git = ["git", "-c", "user.email=t@t", "-c", "user.name=t"]
    subprocess.run(["git", "init", "-q", str(tmp_path)], check=True)
    (tmp_path / "a.py").write_text("x = 1\n")
    subprocess.run(git + ["add", "a.py"], cwd=str(tmp_path), check=True)
    subprocess.run(git + ["commit", "-qm", "seed"], cwd=str(tmp_path),
                   check=True)
    (tmp_path / "a.py").write_text("x = 2\n")  # unstaged edit
    (tmp_path / "b.py").write_text("y = 1\n")  # untracked
    assert incremental.changed_files(str(tmp_path), "HEAD") == {
        "a.py", "b.py"}
