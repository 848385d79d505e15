"""The port's train_pipeline workload (``tpufw_torch.workloads.
train_pipeline``) against ``tpufw``'s (``tests/test_train_pipeline_
workload.py``'s cases): the env -> PipelineTrainer wiring both read from
the same variables (stages, microbatches, the schedule knobs and which
spelling wins, the interleaved v), the shipped manifest's arithmetic,
the refusals (under two stages, a tensor axis that does not divide the
heads, an expert axis on a dense model, the sorted MoE dispatch) and
``main`` on the CPU."""

import dataclasses
import json

import pytest
import torch

from tests.torch_parity import one_torch_thread, workload_env  # noqa: F401
from tpufw.workloads import train_pipeline as jw
from tpufw_torch.workloads import train_pipeline as tw

BASE = dict(PIPE_STAGES=2, MODEL="llama3_tiny", BATCH_SIZE=16, SEQ_LEN=33,
            DEVICE="cpu")


def test_requires_stages(monkeypatch):
    workload_env(monkeypatch, {"DEVICE": "cpu"})
    with pytest.raises(ValueError, match="TPUFW_PIPE_STAGES") as want:
        jw.build_trainer()
    with pytest.raises(ValueError, match="TPUFW_PIPE_STAGES") as got:
        tw.build_trainer()
    assert str(got.value).replace("tpufw_torch.", "tpufw.") == str(
        want.value)


def test_builds_from_env(monkeypatch, devices8):
    """The same env gives the same pipeline and trainer shape as
    ``tpufw``'s; one process holds both stages (its mesh of 8 devices
    has data x fsdp ranks the port's gang would give)."""
    workload_env(monkeypatch, BASE, TOTAL_STEPS=2)
    trainer, cfg = tw.build_trainer()
    workload_env(monkeypatch, BASE, TOTAL_STEPS=2, MESH_DATA=2)
    jtrainer, jcfg = jw.build_trainer()
    assert dataclasses.asdict(trainer.pipe) == dataclasses.asdict(
        jtrainer.pipe)
    assert trainer.pipe.n_microbatches == 4  # default 2 * stages
    assert trainer.group.indices == (0, 1)
    assert trainer.mesh_cfg.pipe == dict(jtrainer.mesh.shape)["pipe"] == 2
    assert trainer.cfg.batch_size == jtrainer.cfg.batch_size == 16
    assert cfg.n_layers % 2 == 0 and cfg.n_layers == jcfg.n_layers


def _manifest_env():
    import pathlib

    import yaml

    repo = pathlib.Path(__file__).resolve().parent.parent
    [doc] = [d for d in yaml.safe_load_all(
        (repo / "deploy" / "manifests" / "08-llama3-8b-pipeline-jobset.yaml"
         ).read_text()) if d]
    [rj] = doc["spec"]["replicatedJobs"]
    [container] = rj["template"]["spec"]["template"]["spec"]["containers"]
    return {e["name"]: e["value"] for e in container["env"] if "value" in e}


def test_manifest_literals_satisfy_pipeline_constraints():
    """The shipped manifest's numbers, as the port's checks read them:
    microbatch rows divide over data x fsdp, the layers over the stages,
    and the gang is the slice's GPUs."""
    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.parallel.pipeline import PipelineConfig

    env = _manifest_env()
    batch = int(env["TPUFW_BATCH_SIZE"])
    micro = int(env["TPUFW_PIPE_MICROBATCHES"])
    stages = int(env["TPUFW_PIPE_STAGES"])
    data = int(env.get("TPUFW_MESH_DATA", 1))
    fsdp = int(env["TPUFW_MESH_FSDP"])
    PipelineConfig(stages, micro).validate(
        resolve_model_preset("llama3_8b"), batch)
    assert (batch // micro) % (data * fsdp) == 0
    workers = int(env["TPUFW_WORKERS_PER_SLICE"])
    assert data * fsdp * stages == workers * 4


def test_manifest_env_builds(monkeypatch):
    """The manifest's literal env builds the port's trainer (the model
    swapped to tiny; fsdp 1: one process holds the pipe)."""
    env = {k[len("TPUFW_"):]: v for k, v in _manifest_env().items()
           if k.startswith("TPUFW_")}
    workload_env(monkeypatch, env, MODEL="llama3_tiny", MESH_FSDP=1,
                 MESH_DATA=1, DEVICE="cpu")
    trainer, _ = tw.build_trainer()
    assert trainer.pipe.n_stages == 2
    assert trainer.cfg.checkpoint_dir == "/checkpoints/llama3-8b-pipeline"


@pytest.mark.parametrize("env,schedule,v", [
    (dict(PIPE_SCHEDULE="1f1b"), "1f1b", 1),
    (dict(PIPE_SCHEDULE="gpipe", PIPELINE_SCHEDULE="1f1b"), "1f1b", 1),
    (dict(PIPELINE_SCHEDULE="zb1"), "zb1", 1),
    (dict(PIPELINE_SCHEDULE="interleaved", PIPELINE_VSTAGES=2,
          MODEL="llama3_tiny_4l"), "interleaved", 2),
])
def test_schedule_from_env(monkeypatch, env, schedule, v):
    """TPUFW_PIPELINE_SCHEDULE wins over TPUFW_PIPE_SCHEDULE; the
    interleaved v reaches the config."""
    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS

    PRESETS.setdefault("llama3_tiny_4l", dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], n_layers=4))
    try:
        workload_env(monkeypatch, BASE, **env)
        trainer, _ = tw.build_trainer()
    finally:
        PRESETS.pop("llama3_tiny_4l", None)
    assert (trainer.pipe.schedule, trainer.pipe.n_virtual) == (schedule, v)


@pytest.mark.parametrize("env,err,match", [
    (dict(PIPE_SCHEDULE="wavefront"), ValueError,
     "unknown pipeline schedule"),
    (dict(PIPELINE_SCHEDULE="interleaved", PIPELINE_VSTAGES=2), ValueError,
     "n_virtual"),
    (dict(MESH_TENSOR=3), ValueError, "must divide n_heads=4"),
    (dict(MESH_EXPERT=2), NotImplementedError, "no experts to shard"),
    (dict(MESH_SEQUENCE=2), NotImplementedError, "sequence has size 2"),
    (dict(MOE_DISPATCH="sorted", MODEL="mixtral_tiny"), NotImplementedError,
     "einsum"),
    (dict(MOE_DISPATCH="sorted"), NotImplementedError, "einsum"),
    (dict(GRAD_ACCUM=2), NotImplementedError, "grad_accum"),
])
def test_refusals_from_env(monkeypatch, env, err, match):
    """What the pipeline does not run raises at build, naming why: the
    interleaved tiny model's 2 layers cannot split into v x S = 4 chunks
    (both knobs arrived), a tensor axis must divide the heads and an
    expert axis needs a MoE model (``tpufw``'s checks), sequence must be
    1 beside pipe, the sorted dispatch is refused (not replaced
    by the capacity router), grad_accum is the schedule's (the YAML run
    config, which a case held until item 13c ported it, is the base of the
    knobs: test_config_yaml_is_the_base_of_the_knobs)."""
    workload_env(monkeypatch, BASE, **env)
    with pytest.raises(err, match=match):
        tw.build_trainer()


def test_config_yaml_is_the_base_of_the_knobs(monkeypatch, tmp_path):
    """TPUFW_CONFIG (item 13c): the YAML's pipeline, trainer and mesh
    sections build the trainer, each TPUFW_* knob over them; the
    autotune knobs land in the trainer's config. ``tpufw``'s pipeline
    workload reads neither, so the port is held to its own loader."""
    cfg = tmp_path / "pipe.yaml"
    cfg.write_text(
        "hardware: {slice: v5e-4, hosts: 1, chips_per_host: 4}\n"
        "model: {preset: llama3_tiny, overrides: {remat_policy: nothing}}\n"
        "trainer: {batch_size: 8, seq_len: 33, lr: 1.0e-3, total_steps: 5}\n"
        "mesh: {fsdp: 2}\n"
        "pipeline: {n_stages: 2, n_microbatches: 4, schedule: 1f1b}\n")
    workload_env(monkeypatch, {"DEVICE": "cpu"}, CONFIG=cfg, MESH_FSDP=1,
                 TOTAL_STEPS=3, AUTOTUNE="cached", AUTOTUNE_STEPS=2,
                 AUTOTUNE_BUDGET_S=7.5)
    trainer, model_cfg = tw.build_trainer()
    assert (trainer.pipe.n_stages, trainer.pipe.n_microbatches,
            trainer.pipe.schedule) == (2, 4, "1f1b")
    assert model_cfg.remat_policy == "nothing"
    assert (trainer.cfg.batch_size, trainer.cfg.seq_len, trainer.cfg.lr,
            trainer.cfg.total_steps) == (8, 33, 1e-3, 3)
    assert (trainer.cfg.autotune, trainer.cfg.autotune_steps,
            trainer.cfg.autotune_budget_s) == ("cached", 2, 7.5)
    workload_env(monkeypatch, {"DEVICE": "cpu"}, CONFIG=cfg, MESH_FSDP=1,
                 PIPE_SCHEDULE="gpipe", PIPELINE_SCHEDULE="zb1")
    assert tw.build_trainer()[0].pipe.schedule == "zb1"
    workload_env(monkeypatch, BASE, AUTOTUNE="sometimes")
    with pytest.raises(ValueError, match=r"off \| cached \| search"):
        tw.build_trainer()



def test_attention_knob_is_not_read(monkeypatch):
    """TPUFW_ATTENTION is ``train_llama``'s knob: ``tpufw``'s pipeline
    workload never reads it, so the preset's backend stands in both
    (``flash`` for ``llama3_600m_bench``). The trainers are stubbed: only
    the model config each ``build_trainer`` hands them is compared."""
    import tpufw.train
    import tpufw_torch.train

    def stub(model_cfg, *args, **kwargs):
        return model_cfg

    monkeypatch.setattr(tpufw.train, "PipelineTrainer", stub)
    monkeypatch.setattr(tpufw_torch.train, "PipelineTrainer", stub)
    workload_env(monkeypatch, {"DEVICE": "cpu"}, ATTENTION="xla",
                 PIPE_STAGES=2)
    _, mine = tw.build_trainer()
    _, ref = jw.build_trainer()
    assert mine.attention_backend == ref.attention_backend == "flash"


TELEMETRY_FIELDS = ("profile_dir", "profile_start", "profile_stop",
                    "telemetry_dir", "metrics_port", "straggler_factor")


def test_telemetry_knobs_land(monkeypatch, devices8):
    """The telemetry and profiling knobs (item 13a) land in the trainer's
    config as ``tpufw``'s build_trainer puts them."""
    knobs = dict(PROFILE_DIR="/tmp/prof", PROFILE_START=1, PROFILE_STOP=2,
                 TELEMETRY_DIR="/tmp/tel", METRICS_PORT=0,
                 STRAGGLER_FACTOR=3.0)
    workload_env(monkeypatch, BASE, **knobs)
    trainer, _ = tw.build_trainer()
    workload_env(monkeypatch, BASE, MESH_DATA=2, **knobs)
    jtrainer, _ = jw.build_trainer()
    mine = {f: getattr(trainer.cfg, f) for f in TELEMETRY_FIELDS}
    assert mine == {f: getattr(jtrainer.cfg, f) for f in TELEMETRY_FIELDS}
    assert mine["metrics_port"] == 0 and mine["straggler_factor"] == 3.0


def test_main_trains_on_cpu(monkeypatch, capsys):
    """``main`` on one process holding both stages: a banner, a JSON line
    a step, the held-out eval, and the summary."""
    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS

    workload_env(monkeypatch, BASE, BATCH_SIZE=8, TOTAL_STEPS=2, LOG_EVERY=1,
                 PIPELINE_SCHEDULE="1f1b", EVAL_EVERY=2, EVAL_BATCHES=1)
    monkeypatch.setitem(PRESETS, "llama3_tiny", dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32))
    assert tw.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert "train_pipeline" in out[0] and "held=[0, 1]" in out[0]
    steps = [json.loads(ln) for ln in out if ln.startswith('{"step"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert any('"eval_loss"' in ln for ln in out)
    assert out[-1].startswith("TRAIN OK")
