"""The port's YAML run configs (``tpufw_torch.configs.loader``) against
``tpufw``'s (``tests/test_configs.py`` case for case):

- the port's own reader of the YAML subset equals ``yaml.safe_load`` on
  every ``deploy/configs/*.yaml`` and on snippets of each rule (YAML 1.1
  scalars: ``1.0e-4`` a float, ``1e-4`` a string, ``on`` a bool), and
  raises, naming the line, on what lies outside the subset. The tests may
  import PyYAML; the port does not;
- ``load_run_config`` equals ``tpufw``'s field by field (dtypes by name),
  ``to_env`` equals ``tpufw``'s, and the deploy manifests agree with it;
- the loud errors: unknown keys, a mesh against the hardware's chips, a
  vision preset for ``train_llama``, a pipeline section that sizes
  ``mesh.pipe``; env over YAML in ``build_trainer``;
- ``tools.eval_ppl --model <file>.yaml`` resolves the model as ``tpufw``'s
  CLI does.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import one_torch_thread, workload_env  # noqa: F401
from tpufw.configs.loader import load_run_config as j_load
from tpufw.configs.loader import to_env as j_to_env
from tpufw_torch.configs.loader import (
    RunConfig,
    YamlSubsetError,
    load_run_config,
    read_yaml,
    to_env,
)
from tpufw_torch.mesh import MeshConfig
from tpufw_torch.train.trainer import TrainerConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "deploy" / "configs").glob("*.yaml"))
MANIFESTS = REPO / "deploy" / "manifests"


def _named(v):
    """A field value with dtypes by name, dataclasses as dicts."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type) and hasattr(v, "dtype"):  # jnp.float32 ...
        return jnp.dtype(v).name
    if dataclasses.is_dataclass(v):
        return {k: _named(x) for k, x in dataclasses.asdict(v).items()}
    return v


def _fields(obj) -> dict:
    return {f.name: _named(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_configs_exist_for_training_baselines():
    names = [p.name for p in CONFIGS]
    assert "bench-v5e1.yaml" in names
    for n in ("03-", "04-", "05-", "06-", "08-"):
        assert any(name.startswith(n) for name in names), names


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_equals_safe_load(path):
    text = path.read_text()
    assert read_yaml(text, str(path)) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_of_record_loads_as_tpufw(path):
    """The RunConfig of each file equals tpufw's: the model config (every
    field tpufw's config has, dtypes by name), the trainer's shared
    fields, the mesh, the hardware, the pipeline; and to_env alike."""
    run, jrun = load_run_config(path), j_load(path)
    assert isinstance(run, RunConfig)
    assert run.family == jrun.family
    assert run.family in ("llama", "mixtral", "gemma", "resnet")
    assert (run.name, run.model_preset) == (jrun.name, jrun.model_preset)
    assert _fields(run.hardware) == _fields(jrun.hardware)
    mine, theirs = _fields(run.model_cfg), _fields(jrun.model_cfg)
    shared = set(mine) & set(theirs)
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
    for key in ("dtype", "param_dtype", "remat_policy", "n_layers",
                "d_model", "vocab_size"):
        if key in theirs:
            assert key in shared, key
    mine, theirs = _fields(run.trainer), _fields(jrun.trainer)
    shared = set(mine) & set(theirs)
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
    assert _fields(run.mesh) == _fields(jrun.mesh)
    assert (run.pipeline is None) == (jrun.pipeline is None)
    if run.pipeline is not None:
        assert _fields(run.pipeline) == _fields(jrun.pipeline)
    assert to_env(run) == j_to_env(jrun)
    assert to_env(run, defaults_too=True) == j_to_env(jrun,
                                                      defaults_too=True)
    if run.family != "resnet":
        assert isinstance(run.trainer, TrainerConfig)
        assert isinstance(run.mesh, MeshConfig)


def _manifest_env(name: str) -> dict:
    """All literal TPUFW_* env values from a manifest (any nesting)."""
    docs = [d for d in yaml.safe_load_all((MANIFESTS / name).read_text())
            if d]
    env: dict[str, str] = {}

    def walk(node):
        if isinstance(node, dict):
            if (isinstance(node.get("name"), str)
                    and node["name"].startswith("TPUFW_")
                    and isinstance(node.get("value"), str)):
                env[node["name"]] = node["value"]
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(docs)
    return env


@pytest.mark.parametrize("cfg_name, manifest_name", [
    ("03-resnet50-v5e1.yaml", "03-resnet50-v5e1.yaml"),
    ("04-llama3-8b-v5e4.yaml", "04-llama3-8b-v5e4.yaml"),
    ("05-llama3-8b-v5e16.yaml", "05-llama3-8b-v5e16-jobset.yaml"),
    ("06-mixtral-8x7b-v5p32.yaml", "06-mixtral-8x7b-v5p32-jobset.yaml"),
    ("08-llama3-8b-pipeline.yaml", "08-llama3-8b-pipeline-jobset.yaml"),
    ("09-gemma2-2b-v5e4.yaml", "09-gemma2-2b-v5e4.yaml"),
])
def test_manifest_matches_yaml_of_record(cfg_name, manifest_name):
    want = to_env(load_run_config(REPO / "deploy" / "configs" / cfg_name))
    got = _manifest_env(manifest_name)
    for key, val in want.items():
        assert got.get(key) == val, (manifest_name, key)


# Snippets of each rule of the subset, each equal to yaml.safe_load.
SNIPPETS = [
    "a: 1e-4", "a: 1.0e-4", "a: 1.0E+3", "a: .5", "a: -.inf", "a: .NaN",
    "a: on", "a: Off", "a: yes", "a: y", "a: 0x1F", "a: 0b101", "a: 010",
    "a: 1:30", "a: 1_000", "a: +12", "a: ~", "a: null", "a:", "a: ''",
    "a: 'x''y' # c", 'a: "q\\tz\\u00e9"', "a: {b: {x: 2.5, y: no}, c: {}}",
    "a: {'y z': 1, k: v}", "x: http://h:80/p", "a: {u: x:1}",
    "a: b#c", "# only\na:\n  b:\n    c: 1\n  d: 2\ne: f",
    "1: one\n2.5: two\nno: three", "k: v   # trailing",
    "'quoted key': 1", "a: =x",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_reader_snippets_equal_safe_load(text):
    got, want = read_yaml(text), yaml.safe_load(text)
    if text == "a: .NaN":
        assert np.isnan(got["a"]) and np.isnan(want["a"])
    else:
        assert got == want and type(got) is type(want)


# Outside the subset or malformed: each raises, naming the line.
OUTSIDE = {
    "anchor": ("a: 1\nb: &x 2", 2), "alias": ("a: *x", 1),
    "tag": ("a: !!str 1", 1), "block_scalar": ("a: |\n  text", 1),
    "folded_scalar": ("a: >\n  text", 1),
    "block_sequence": ("a:\n  - 1\n  - 2", 2),
    "documents": ("a: 1\n---\nb: 2", 2), "directive": ("%YAML 1.1\na: 1", 1),
    "mapping_in_plain": ("a: b: c", 1), "duplicate_key": ("a: 1\na: 2", 2),
    "open_flow": ("a: {b: 1,\n  c: 2}", 1), "multi_line_plain": ("a: x\n  y", 2),
    "timestamp": ("a: 2001-12-14", 1), "merge": ("<<: 1", 1),
    "tab_indent": ("a:\n\tb: 1", 2), "complex_key": ("? a\n: b", 1),
    "bad_indent": ("a:\n    b: 1\n  c: 2", 3),
    "sequence_entry_as_value": ("a: -", 1),
    "flow_sequence": ("a: 1\nb: {c: [1, 2]}", 2),
}


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_outside_the_subset_raises_naming_the_line(case):
    text, line = OUTSIDE[case]
    with pytest.raises(YamlSubsetError, match=rf"^f\.yaml:{line}: "):
        read_yaml(text, "f.yaml")


def _write(tmp_path, text, name="bad.yaml"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    return path


def test_mesh_hardware_mismatch_is_loud(tmp_path):
    bad = _write(tmp_path, """
        name: bad
        hardware: {slice: v5e-4, hosts: 1, chips_per_host: 4}
        model: {preset: llama3_8b}
        mesh: {fsdp: 8}
        """)
    with pytest.raises(ValueError) as got:
        load_run_config(bad)
    with pytest.raises(ValueError) as want:
        j_load(bad)
    assert str(got.value) == str(want.value)


def test_unknown_keys_are_loud(tmp_path):
    bad = _write(tmp_path, """
        model: {preset: llama3_8b}
        trainer: {batch_sz: 8}
        """)
    with pytest.raises(ValueError, match="unknown keys.*batch_sz"):
        load_run_config(bad)
    top = _write(tmp_path, "model: {preset: llama3_8b}\nextra: 1\n",
                 "top.yaml")
    with pytest.raises(ValueError, match="unknown keys.*extra"):
        load_run_config(top)
    none = _write(tmp_path, "trainer: {batch_size: 8}\n", "none.yaml")
    with pytest.raises(ValueError, match="model.preset missing"):
        load_run_config(none)


def test_model_overrides_applied_and_checked(tmp_path):
    cfg = _write(tmp_path, """
        model:
          preset: llama3_tiny
          overrides: {attention_backend: xla, param_dtype: bfloat16}
        """, "c.yaml")
    run = load_run_config(cfg)
    assert run.model_cfg.attention_backend == "xla"
    assert run.model_cfg.param_dtype == torch.bfloat16
    assert _named(run.model_cfg.param_dtype) == _named(
        j_load(cfg).model_cfg.param_dtype)
    bad = _write(tmp_path,
                 "model: {preset: llama3_tiny, overrides: {n_headz: 2}}\n",
                 "b.yaml")
    with pytest.raises(ValueError, match="unknown keys.*n_headz"):
        load_run_config(bad)
    dt = _write(tmp_path,
                "model: {preset: llama3_tiny, overrides: {dtype: bf17}}\n",
                "d.yaml")
    with pytest.raises(ValueError, match="unknown dtype 'bf17'"):
        load_run_config(dt)


def test_rope_scaling_override_coerced(tmp_path):
    from tpufw_torch.models.llama import RopeScaling

    cfg = _write(tmp_path, """
        model:
          preset: llama3_tiny
          overrides:
            rope_scaling: {factor: 4.0, original_max_position_embeddings: 64}
        """, "c.yaml")
    run = load_run_config(cfg)
    assert run.model_cfg.rope_scaling == RopeScaling(
        factor=4.0, original_max_position_embeddings=64)
    assert _named(run.model_cfg.rope_scaling) == _named(
        j_load(cfg).model_cfg.rope_scaling)
    lin = _write(tmp_path, "model: {preset: llama3_tiny, overrides: "
                 "{rope_scaling: {rope_type: linear, factor: 4.0}}}\n",
                 "l.yaml")
    assert load_run_config(lin).model_cfg.rope_scaling.rope_type == "linear"
    bad = _write(tmp_path, "model: {preset: llama3_tiny, overrides: "
                 "{rope_scaling: {bogus_knob: 1}}}\n", "b.yaml")
    with pytest.raises(ValueError, match="unknown keys.*bogus_knob"):
        load_run_config(bad)


def test_env_overrides_yaml_in_build_trainer(monkeypatch):
    """TPUFW_CONFIG is the base layer; TPUFW_* env wins on top, in the
    port's build_trainer as in tpufw's."""
    from tpufw.workloads import train_llama as j_train_llama
    from tpufw_torch.workloads import train_llama

    cfg = REPO / "deploy" / "configs" / "04-llama3-8b-v5e4.yaml"
    workload_env(monkeypatch, {"DEVICE": "cpu"}, CONFIG=cfg,
                 MODEL="llama3_tiny", TOTAL_STEPS=7, MESH_FSDP=-1)
    trainer, model_cfg = train_llama.build_trainer()
    jtrainer, jmodel_cfg = j_train_llama.build_trainer()
    assert trainer.cfg.total_steps == jtrainer.cfg.total_steps == 7
    assert model_cfg.n_layers == jmodel_cfg.n_layers < 8
    for f in ("batch_size", "seq_len", "checkpoint_dir", "checkpoint_every",
              "lr", "loss_chunk_size", "log_every"):
        assert getattr(trainer.cfg, f) == getattr(jtrainer.cfg, f), f
    assert (trainer.cfg.batch_size, trainer.cfg.seq_len) == (8, 2048)
    assert trainer.cfg.checkpoint_dir == "/checkpoints/llama3-8b-v5e4"


def test_bench_yaml_through_build_trainer(monkeypatch):
    """The YAML's own preset keeps its model overrides (full remat), the
    env overrides the file's batch and steps; phase 22c's case."""
    from tpufw_torch.workloads import train_llama

    cfg = REPO / "deploy" / "configs" / "bench-v5e1.yaml"
    workload_env(monkeypatch, {"DEVICE": "cpu"}, CONFIG=cfg, BATCH_SIZE=4,
                 TOTAL_STEPS=3)
    trainer, model_cfg = train_llama.build_trainer()
    assert model_cfg.remat_policy == "nothing" and model_cfg.n_layers == 14
    assert (trainer.cfg.batch_size, trainer.cfg.total_steps,
            trainer.cfg.loss_chunk_size, trainer.cfg.lr) == (4, 3, 512, 1e-4)


def test_vision_preset_refused_by_train_llama(monkeypatch):
    from tpufw_torch.workloads import train_llama

    workload_env(monkeypatch, {"DEVICE": "cpu"},
                 CONFIG=REPO / "deploy" / "configs" / "03-resnet50-v5e1.yaml")
    with pytest.raises(ValueError, match="not an LM config"):
        train_llama.build_trainer()


def test_pipeline_section_sizes_mesh_and_validates(tmp_path):
    good = _write(tmp_path, """
        hardware: {slice: v5e-4, hosts: 1, chips_per_host: 4}
        model: {preset: llama3_tiny}
        trainer: {batch_size: 8}
        mesh: {fsdp: 2}
        pipeline: {n_stages: 2, n_microbatches: 4}
        """, "p.yaml")
    run = load_run_config(good)
    assert run.mesh.pipe == 2
    env = to_env(run)
    assert env == j_to_env(j_load(good))
    assert env["TPUFW_PIPE_STAGES"] == "2"
    assert "TPUFW_MESH_PIPE" not in env
    bad = _write(tmp_path, """
        model: {preset: llama3_tiny}
        mesh: {pipe: 4}
        pipeline: {n_stages: 2, n_microbatches: 2}
        """)
    with pytest.raises(ValueError, match="mesh.pipe=4"):
        load_run_config(bad)


def test_bench_yaml_matches_bench_tier():
    run = load_run_config(REPO / "deploy" / "configs" / "bench-v5e1.yaml")
    assert run.model_preset == "llama3_600m_bench"
    assert run.trainer.batch_size == 24
    assert run.trainer.seq_len == 2048
    assert run.trainer.loss_chunk_size == 512
    assert run.model_cfg.remat_policy == "nothing"


def test_eval_ppl_takes_a_yaml_model(tmp_path, capsys, monkeypatch):
    """``--model <file>.yaml`` goes through ``load_run_config`` (the
    file's overrides kept), as tpufw's CLI: the config of
    bench-v5e1.yaml equals tpufw's field by field; a tiny YAML evaluates
    end to end on the CPU."""
    from tpufw_torch.models import PRESETS
    from tpufw_torch.tools import eval_ppl
    from tpufw_torch.train import Trainer, write_token_corpus
    from tpufw_torch.train.checkpoint import save_params

    bench = REPO / "deploy" / "configs" / "bench-v5e1.yaml"
    mine = _fields(eval_ppl.model_config(str(bench)))
    theirs = _fields(j_load(bench).model_cfg)
    assert {k: mine[k] for k in theirs if k in mine} == {
        k: theirs[k] for k in theirs if k in mine}
    assert mine["remat_policy"] == "nothing" and mine["param_dtype"] == \
        "float32"
    assert eval_ppl.model_config("llama3_tiny") == PRESETS["llama3_tiny"]

    cfg = dataclasses.replace(PRESETS["llama3_tiny"], dtype=torch.float32)
    monkeypatch.setitem(PRESETS, "llama3_tiny", cfg)
    tiny = _write(tmp_path, "model: {preset: llama3_tiny, overrides: "
                  "{remat_policy: nothing}}\n", "tiny.yml")
    t = Trainer(cfg, TrainerConfig(batch_size=4, seq_len=17), device="cpu")
    t.init_state(seed=0)
    save_params(str(tmp_path / "p"), t.model.state_dict(), cfg)
    rng = np.random.default_rng(0)
    write_token_corpus(str(tmp_path / "c"), [
        rng.integers(1, 256, rng.integers(5, 40)) for _ in range(20)])
    assert eval_ppl.main([
        "--model", str(tiny), "--params", str(tmp_path / "p"), "--data",
        str(tmp_path / "c"), "--batch-size", "4", "--seq-len", "17",
        "--batches", "2", "--loss-chunk-size", "8", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert np.isfinite(line["eval_loss"]) and line["eval_tokens"] > 0
