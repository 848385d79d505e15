"""tpufw_torch.train.checkpoint and the trainer's resume against tpufw:
save and restore under both optimizer forms (3 steps + restore + 3 steps
bit-equal to 6), max_to_keep, a half-written step ignored, another
model's checkpoint refused, the resumed trajectory against tpufw's
uninterrupted run, resume_data_seed against tpufw's, bare params, and
tools.eval_ppl against Trainer.evaluate and tpufw's evaluation. CPU."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.workloads._common import resume_data_seed as j_resume_data_seed
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS, PRESETS
from tpufw_torch.train import (
    CheckpointManager,
    TokenCorpus,
    Trainer,
    TrainerConfig,
    synthetic_batches,
    write_token_corpus,
)
from tpufw_torch.train.checkpoint import (
    checksums,
    config_identity,
    save_params,
)
from tpufw_torch.workloads._common import resume_data_seed

CFG = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
KW = dict(batch_size=8, seq_len=17, total_steps=6, lr=1e-2, warmup_steps=1,
          loss_chunk_size=8, loss_chunk_dtype="float32")
BATCHES = list(synthetic_batches(8, 17, CFG.vocab_size, seed=3, n_batches=6))


def _run(tmp_path, mu_dtype, **kw):
    trainer = Trainer(CFG, TrainerConfig(**KW, adam_mu_dtype=mu_dtype,
                                         **kw), device="cpu")
    trainer.init_state(seed=0)
    return trainer, trainer.run(iter(BATCHES), 1.0)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_three_restore_three_equals_six(tmp_path, mu_dtype):
    ckpt = str(tmp_path / "ckpt")
    full, hist = _run(tmp_path, mu_dtype, checkpoint_dir=ckpt,
                      checkpoint_every=3)
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [3, 6]
    state = mgr.restore(3)
    assert state["step"] == 3 and state["optimizer"]["count"] == 3
    assert state["config"] == config_identity(CFG)
    resumed = Trainer(CFG, TrainerConfig(**KW, adam_mu_dtype=mu_dtype),
                      device="cpu")
    resumed.load_state_dict(state)
    hist2 = resumed.run(iter(BATCHES[3:]), 1.0)
    assert [m.step for m in hist2] == [4, 5, 6]
    assert [m.loss for m in hist2] == [m.loss for m in hist[3:]]
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert checksums(full.optimizer.state_dict()) == checksums(
        resumed.optimizer.state_dict())
    # maybe_restore resumes the latest step, whole.
    latest = Trainer(CFG, TrainerConfig(**KW, adam_mu_dtype=mu_dtype,
                                        checkpoint_dir=ckpt), device="cpu")
    assert latest.maybe_restore() and latest.step == 6
    assert checksums(latest.state_dict()) == checksums(full.state_dict())


def test_optimizer_form_must_match(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _run(tmp_path, None, checkpoint_dir=ckpt, checkpoint_every=6)
    other = Trainer(CFG, TrainerConfig(**KW, adam_mu_dtype="bfloat16",
                                       checkpoint_dir=ckpt), device="cpu")
    with pytest.raises(ValueError, match="other form"):
        other.maybe_restore()


def test_max_to_keep_interval_and_forced_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2,
                            save_interval_steps=2)
    state = {"w": torch.arange(4.0), "n": 1}
    assert not mgr.save(1, state)  # off the interval
    for step in (2, 4, 6):
        assert mgr.save(step, state)
    assert mgr.save(7, state, force=True)
    mgr.wait()
    assert mgr.all_steps() == [6, 7]
    assert not mgr.save(7, state, force=True)  # already on disk
    assert [s["step"] for s in mgr.saves] == [2, 4, 6, 7]
    assert all(s["write_s"] >= 0 and s["bytes"] == 16 for s in mgr.saves)


def test_half_written_step_is_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": torch.ones(3)})
    mgr.wait()
    # A save killed mid-write leaves its temporary directory; a step
    # directory without its meta.json is not a step either.
    (tmp_path / ".tmp-9-123").mkdir()
    (tmp_path / ".tmp-9-123" / "state.pt").write_bytes(b"\x00" * 10)
    (tmp_path / "8").mkdir()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore()["w"], torch.ones(3))


def test_corrupted_tensor_and_other_model_are_refused(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _run(tmp_path, None, checkpoint_dir=ckpt, checkpoint_every=6)
    meta_path = os.path.join(ckpt, "6", "meta.json")
    meta = json.loads(open(meta_path).read())
    key = next(iter(meta["checksums"]))
    meta["checksums"][key][0] += 1
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="differ from the save"):
        CheckpointManager(ckpt).restore()
    ckpt2 = str(tmp_path / "ckpt2")
    _run(tmp_path, None, checkpoint_dir=ckpt2, checkpoint_every=6)
    wider = Trainer(dataclasses.replace(CFG, d_ff=256),
                    TrainerConfig(**KW, checkpoint_dir=ckpt2), device="cpu")
    with pytest.raises(ValueError, match="different model"):
        wider.maybe_restore()
    # A runtime-only change (attention backend, remat) restores fine.
    flash = Trainer(dataclasses.replace(CFG, attention_backend="flash",
                                        remat=True),
                    TrainerConfig(**KW, checkpoint_dir=ckpt2), device="cpu")
    assert flash.maybe_restore()


def test_resumed_trajectory_matches_tpufw_uninterrupted(tmp_path, devices8):
    """tpufw trains 6 steps in one go; the port trains 3, saves, a fresh
    trainer restores and trains 3 more, from the same Flax init and
    batches: every loss agrees to test_torch_trainer's 1e-4."""
    jcfg = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32)
    jt = JTrainer(JLlama(jcfg), JTrainerConfig(**KW), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(jt.state.params)
    j_hist = jt.run(iter(BATCHES), model_flops_per_token=1.0)

    ckpt = str(tmp_path / "ckpt")
    # The schedule spans all 6 steps; the first run's data ends at 3.
    first = Trainer(CFG, TrainerConfig(**KW, checkpoint_dir=ckpt,
                                       checkpoint_every=3), device="cpu")
    first.init_state(state_dict=params_from_flax(params, CFG))
    h1 = first.run(iter(BATCHES[:3]), 1.0)
    second = Trainer(CFG, TrainerConfig(**KW, checkpoint_dir=ckpt),
                     device="cpu")
    assert second.maybe_restore() and second.step == 3
    h2 = second.run(iter(BATCHES[3:]), 1.0)
    np.testing.assert_allclose([m.loss for m in h1 + h2],
                               [m.loss for m in j_hist], rtol=1e-4)


@pytest.mark.parametrize("step", [0, 1, 3, 1000])
@pytest.mark.parametrize("base", [0, 7])
def test_resume_data_seed_matches_tpufw(base, step):
    assert resume_data_seed(base, step) == j_resume_data_seed(base, step)


def test_init_from_params_starts_at_step_zero(tmp_path):
    src = Trainer(CFG, TrainerConfig(**KW), device="cpu")
    src.init_state(seed=4)
    save_params(str(tmp_path / "p"), src.model.state_dict(), CFG)
    t = Trainer(CFG, TrainerConfig(**KW), device="cpu")
    t.init_from_params(str(tmp_path / "p"))
    assert t.step == 0 and t.optimizer.count == 0
    for a, b in zip(src.model.state_dict().values(),
                    t.model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="initialized trainer"):
        t.init_from_params(str(tmp_path / "p"))
    other = Trainer(PRESETS["qwen25_tiny"], TrainerConfig(**KW), device="cpu")
    with pytest.raises(ValueError, match="different model"):
        other.init_from_params(str(tmp_path / "p"))


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 256, rng.integers(5, 40)) for _ in range(60)]
    prefix = str(tmp_path / "corpus")
    write_token_corpus(prefix, docs)
    return prefix


def test_eval_ppl_matches_evaluate_and_tpufw(tmp_path, corpus, capsys,
                                             monkeypatch, devices8):
    """One JSON line from bare params and from a training checkpoint:
    equal to Trainer.evaluate on the same corpus batches, and to tpufw's
    evaluation of the same weights (params_from_flax) at 2e-4."""
    from tpufw_torch.tools import eval_ppl

    monkeypatch.setitem(PRESETS, "llama3_tiny", CFG)
    jcfg = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32)
    jt = JTrainer(JLlama(jcfg), JTrainerConfig(batch_size=8, seq_len=17,
                                               loss_chunk_size=8),
                  MeshConfig(data=8))
    jt.init_state(seed=0)
    want = jt.evaluate(iter(TokenCorpus(corpus, 8, 17, epochs=1)), None)
    state = params_from_flax(jax.device_get(jt.state.params), CFG)
    save_params(str(tmp_path / "p"), state, CFG)
    t = Trainer(CFG, TrainerConfig(batch_size=8, seq_len=17,
                                   loss_chunk_size=8,
                                   checkpoint_dir=str(tmp_path / "ck"),
                                   checkpoint_every=1, total_steps=1),
                device="cpu")
    t.init_state(state_dict=state)
    evaluate = t.evaluate(iter(TokenCorpus(corpus, 8, 17, epochs=1)), None)
    common = ["--model", "llama3_tiny", "--data", corpus, "--batch-size",
              "8", "--seq-len", "17", "--batches", "0",
              "--loss-chunk-size", "8", "--device", "cpu"]
    assert eval_ppl.main(["--params", str(tmp_path / "p"), *common]) == 0
    line = json.loads(capsys.readouterr().out)
    assert {k: line[k] for k in evaluate} == evaluate
    for k in ("eval_loss", "eval_ppl"):
        np.testing.assert_allclose(line[k], want[k], rtol=2e-4, atol=2e-4)
    assert line["eval_tokens"] == want["eval_tokens"]
    # A training checkpoint of the same run after one step.
    t.run(iter(BATCHES), 1.0)
    after = t.evaluate(iter(TokenCorpus(corpus, 8, 17, epochs=1)), None)
    assert eval_ppl.main(["--checkpoint", str(tmp_path / "ck"),
                          *common]) == 0
    line = json.loads(capsys.readouterr().out)
    assert {k: line[k] for k in after} == after
