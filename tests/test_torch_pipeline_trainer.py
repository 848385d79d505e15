"""The port's PipelineTrainer (``tpufw_torch.train.pipeline_trainer``)
against ``tpufw``'s (``tests/test_pipeline_trainer.py``'s cases): three
steps from the same numpy-made params on the same batches give
``tpufw``'s losses and params at 2e-4 (its optimizer recipe, its
schedule); then the surface on a ``LocalPipeGroup``: metering, the stage
layout of params and moments, a bit-equal checkpoint resume, the
token-weighted evaluation and ``eval_every``, the chunked CE against full
logits, packed batches, and the refusals."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    TOL,
    assert_trees_close,
    llama_pair,
    np_params,
    to_numpy,
    torch_batch,
    torch_params,
)
from tpufw_torch.parallel.pipeline import (
    PipelineConfig,
    pipeline_eval,
    tree_leaves,
)
from tpufw_torch.train import (
    PipelineTrainer,
    TrainerConfig,
    synthetic_batches,
    synthetic_packed_batches,
)

JCFG, TCFG = llama_pair()
PIPE = PipelineConfig(n_stages=2, n_microbatches=4)
KW = dict(batch_size=16, seq_len=33, total_steps=8, lr=1e-2, warmup_steps=2)


def _trainer(pipe=PIPE, **over):
    return PipelineTrainer(TCFG, pipe, TrainerConfig(**{**KW, **over}),
                           device="cpu")


def _batches(n, seed=0, packed=False):
    make = synthetic_packed_batches if packed else synthetic_batches
    extra = {"mean_doc_len": 8} if packed else {}
    it = make(16, 33, TCFG.vocab_size, seed=seed, **extra)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_trainer_matches_tpufw(devices8, schedule):
    """Three steps of ``tpufw``'s PipelineTrainer on a data x pipe x fsdp
    mesh and of the port's on one process, from the same params on the
    same batches: losses, grad-norm-clipped AdamW updates and params."""
    from tpufw.mesh import MeshConfig as JMeshConfig
    from tpufw.parallel.pipeline import PipelineConfig as JPipe
    from tpufw.train import PipelineTrainer as JTrainer
    from tpufw.train import TrainerConfig as JTrainerConfig

    params = np_params(JCFG, 2, seed=3)
    data = _batches(3, seed=4)
    kw = dict(KW, total_steps=3, log_every=1)
    jt = JTrainer(JCFG, JPipe(2, 4, schedule), JTrainerConfig(**kw),
                  JMeshConfig(data=2, pipe=2, fsdp=2))
    jt.init_state()
    sh = jt._shardings
    jparams = jax.device_put(params, sh.params)
    jt.state = jt.state.replace(params=jparams,
                                opt_state=jax.device_put(
                                    jt.tx.init(jparams), sh.opt_state))
    want = [m.loss for m in jt.run(iter(data), model_flops_per_token=1.0)]
    tt = PipelineTrainer(TCFG, PipelineConfig(2, 4, schedule),
                         TrainerConfig(**kw, handle_preemption=False),
                         device="cpu")
    tt.init_state(params=torch_params(params))
    got = [m.loss for m in tt.run(iter(data), model_flops_per_token=1.0)]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert_trees_close(to_numpy(tt.whole_params()),
                       jax.device_get(jt.state.params), **TOL)


def test_trains_and_meters():
    t = _trainer()
    t.init_state()
    hist = t.run(synthetic_batches(16, 33, TCFG.vocab_size),
                 model_flops_per_token=TCFG.flops_per_token(32))
    assert len(hist) == 8
    assert hist[-1].loss < hist[0].loss
    assert hist[-1].tokens_per_sec_per_gpu > 0
    assert np.isfinite(hist[-1].mfu)


def test_stage_params_and_moments_hold_the_stage_axis():
    """Every stage stack (and its Adam moments) keeps ``tpufw``'s leading
    stage axis; a LocalPipeGroup holds both stages."""
    t = _trainer(total_steps=1)
    t.init_state()
    assert t.params["stages"]["wq"].shape[:2] == (2, 2)
    t.run(synthetic_batches(16, 33, TCFG.vocab_size),
          model_flops_per_token=1.0)
    state = t.optimizer.state_dict()["adamw"]["state"]
    shapes = {tuple(p.shape) for _, p in tree_leaves(t.params["stages"])}
    moments = [tuple(s["exp_avg"].shape) for s in state.values()
               if tuple(s["exp_avg"].shape) in shapes]
    assert moments and all(m[0] == 2 for m in moments)


def test_checkpoint_resume(tmp_path):
    """A resumed run continues bit-equal: the params restored exactly,
    the global step budget honoured, and the resumed steps equal to an
    unbroken run's."""
    ckpt = str(tmp_path / "pipe-ckpt")
    data = _batches(5)
    full = _trainer(total_steps=5)
    full.init_state()
    h_full = full.run(iter(data), model_flops_per_token=1.0)
    t = _trainer(checkpoint_dir=ckpt, checkpoint_every=1, total_steps=3)
    t.init_state()
    t.run(iter(data[:3]), model_flops_per_token=1.0)
    w_before = t.params["stages"]["wq"].detach().clone()
    t2 = _trainer(checkpoint_dir=ckpt, checkpoint_every=1, total_steps=5)
    assert t2.maybe_restore()
    assert t2.step == 3
    torch.testing.assert_close(t2.params["stages"]["wq"].detach(), w_before,
                               rtol=0, atol=0)
    hist = t2.run(iter(data[3:]), model_flops_per_token=1.0)
    assert t2.step == 5 and len(hist) == 2
    assert [h.loss for h in hist] == [h.loss for h in h_full[3:]]
    for (path, a), (_, b) in zip(tree_leaves(t2.params),
                                 tree_leaves(full.params)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0,
                                   msg=path)


def test_unsupported_features_are_loud():
    with pytest.raises(NotImplementedError, match="grad_accum"):
        _trainer(grad_accum=2)


def test_packed_batches_train():
    t = _trainer(total_steps=6)
    t.init_state()
    hist = t.run(synthetic_packed_batches(16, 33, TCFG.vocab_size,
                                          mean_doc_len=8),
                 model_flops_per_token=TCFG.flops_per_token(32))
    assert len(hist) == 6
    assert np.isfinite(hist[-1].loss) and hist[-1].loss < hist[0].loss


@pytest.mark.parametrize("mesh,match", [
    (dict(pipe=4, fsdp=2), "mesh_cfg.pipe=4"),
    (dict(pipe=2, data=2), "1 devices not divisible"),
])
def test_mesh_mismatch_is_loud(mesh, match):
    """A mesh whose pipe is not the stage count raises (``tpufw``'s
    message); so does one whose other axes need more than this process
    on a LocalPipeGroup."""
    from tpufw_torch.mesh import MeshConfig

    with pytest.raises(ValueError, match=match):
        PipelineTrainer(TCFG, PIPE, TrainerConfig(batch_size=16, seq_len=33),
                        MeshConfig(**mesh), device="cpu")


def test_evaluate_token_weighted():
    t = _trainer(total_steps=2)
    t.init_state()
    t.run(synthetic_batches(16, 33, TCFG.vocab_size),
          model_flops_per_token=1.0)
    ev = t.evaluate(synthetic_batches(16, 33, TCFG.vocab_size, seed=9), 3)
    assert ev["eval_batches"] == 3
    assert ev["eval_tokens"] == 3 * 16 * 32
    assert np.isfinite(ev["eval_loss"])
    assert ev["eval_ppl"] == pytest.approx(np.exp(ev["eval_loss"]), rel=1e-6)
    ev2 = t.evaluate(synthetic_batches(16, 33, TCFG.vocab_size, seed=9), 3)
    assert ev2["eval_loss"] == ev["eval_loss"]


def test_eval_every_in_run():
    seen = []
    t = _trainer(total_steps=4, eval_every=2, eval_batches=2)
    t.init_state()
    t.run(synthetic_batches(16, 33, TCFG.vocab_size),
          model_flops_per_token=1.0,
          eval_data=lambda: synthetic_batches(16, 33, TCFG.vocab_size,
                                              seed=9),
          on_eval=seen.append)
    assert [ev["step"] for ev in seen] == [2, 4]
    assert all(np.isfinite(ev["eval_loss"]) for ev in seen)


@pytest.mark.parametrize("pipe", [PIPE, PipelineConfig(2, 4, "interleaved",
                                                       2)],
                         ids=["gpipe", "interleaved"])
def test_chunked_ce_matches_full_logits(pipe):
    """The chunked CE (fp32 chunks) of the forward-only pipeline equals
    the full-logits objective; interleaved stacks evaluate through their
    own schedule's forward sub-ticks."""
    t = _trainer(pipe=pipe, total_steps=1)
    t.init_state()
    batch = torch_batch(next(synthetic_batches(16, 33, TCFG.vocab_size)))
    full = pipeline_eval(t.params, batch, TCFG, pipe)
    chunked = pipeline_eval(t.params, batch, TCFG, pipe, loss_chunk_size=16,
                            loss_chunk_dtype=torch.float32)
    np.testing.assert_allclose(float(chunked["loss"]), float(full["loss"]),
                               rtol=1e-6)
    assert float(chunked["n_tokens"]) == float(full["n_tokens"])


def test_trains_with_chunked_ce():
    t = _trainer(total_steps=3, loss_chunk_size=16)
    t.init_state()
    hist = t.run(synthetic_batches(16, 33, TCFG.vocab_size),
                 model_flops_per_token=1.0)
    assert len(hist) == 3 and np.isfinite(hist[-1].loss)


def test_group_must_be_local():
    from tpufw_torch.parallel.group import ProcessPipeGroup

    with pytest.raises(TypeError, match="LocalPipeGroup"):
        PipelineTrainer(TCFG, PIPE, TrainerConfig(**KW), device="cpu",
                        group=ProcessPipeGroup(None, 2, 0))
    with pytest.raises(ValueError, match="mesh pipe axis has size 3"):
        from tpufw_torch.parallel.group import LocalPipeGroup

        PipelineTrainer(TCFG, PIPE, TrainerConfig(**KW), device="cpu",
                        group=LocalPipeGroup(3))


def test_sigterm_stops_with_a_checkpoint(tmp_path):
    """A stop request ends the loop at the next sync point with a forced
    checkpoint, as the Trainer's (``train.preemption``)."""
    from tpufw_torch.train.checkpoint import CheckpointManager
    from tpufw_torch.train.preemption import GracefulShutdown

    ckpt = str(tmp_path / "stop")
    t = _trainer(total_steps=6, checkpoint_dir=ckpt, checkpoint_every=100,
                 log_every=1)
    t.init_state()
    stop = GracefulShutdown(signals=())
    t.run(synthetic_batches(16, 33, TCFG.vocab_size),
          model_flops_per_token=1.0,
          on_metrics=lambda m: stop.request() if m.step == 2 else None,
          shutdown=stop)
    assert t.preempted and t.step == 2
    assert CheckpointManager(ckpt).all_steps() == [2]


def test_moe_and_gemma_train_through_gpipe():
    """The GPipe families beyond Llama train through the trainer too."""
    from tpufw_torch.configs import resolve_model_preset

    for name in ("mixtral_tiny", "gemma2_tiny", "deepseek_moe_tiny"):
        cfg = dataclasses.replace(resolve_model_preset(name),
                                  dtype=torch.float32)
        t = PipelineTrainer(cfg, PIPE, TrainerConfig(**{**KW,
                                                        "total_steps": 2}),
                            device="cpu")
        t.init_state()
        hist = t.run(synthetic_batches(16, 33, cfg.vocab_size),
                     model_flops_per_token=1.0)
        assert len(hist) == 2 and np.isfinite(hist[-1].loss), name
