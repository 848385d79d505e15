"""The sharded trainers at world size 1, in this process: a gloo group of
one rank, so ``fully_shard``, DTensor parameters, the gang's loss weights,
the gathering checkpoint and the stop's all-reduce all run, and every
number must equal the unwrapped trainer's bit for bit (what the card's
world-1 NCCL group is held to), for the LM objectives and those over the
whole batch (GRPO, contrastive, vision). Plus the refusals of the meshes
that are not ported to a gang."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.fsdp import FSDPModule

from tests.torch_gang import free_port
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.cluster import init_process_group
from tpufw_torch.mesh import MeshConfig
from tpufw_torch.models import (
    DEEPSEEK_CONFIGS,
    GEMMA_CONFIGS,
    LLAMA_CONFIGS,
    MIXTRAL_CONFIGS,
    ResNetConfig,
    ViTConfig,
)
from tpufw_torch.train import (
    ContrastiveConfig,
    DPOTrainer,
    EmbeddingTrainer,
    GRPOConfig,
    GRPOTrainer,
    Trainer,
    TrainerConfig,
    VisionTrainer,
    VisionTrainerConfig,
    synthetic_batches,
    synthetic_images,
)
from tpufw_torch.train.checkpoint import CheckpointManager
from tpufw_torch.train.preemption import GracefulShutdown
from tpufw_torch.train.sharding import full_state_dict, is_dtensor

KW = dict(batch_size=8, seq_len=17, total_steps=3, lr=1e-2, warmup_steps=1,
          loss_chunk_size=8, loss_chunk_dtype="float32",
          handle_preemption=False, log_every=1)
F32 = dict(dtype=torch.float32)
TINY = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], **F32)


@contextlib.contextmanager
def world1():
    import torch.distributed as dist

    init_process_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batches(n=3, seed=3):
    it = synthetic_batches(8, 17, 256, seed=seed)
    return [next(it) for _ in range(n)]


def _run(cfg, batches, cls=Trainer, seed=0, **kw):
    """(trainer, [(loss, grad_norm)] a step) of ``batches`` through run."""
    tr = cls(cfg, TrainerConfig(**{**KW, **kw}), device="cpu")
    tr.init_state(seed=seed)
    rec = []
    step = tr.train_step

    def recorded(b):
        m = step(b)
        rec.append((float(m["loss"]), float(m["grad_norm"])))
        return m

    tr.train_step = recorded
    tr.run(iter(batches), model_flops_per_token=1.0)
    return tr, rec


def _assert_bit_equal(cfg, cls=Trainer, rtol=0.0, **kw):
    """Losses, grad norms and final parameters of the sharded run equal
    the unwrapped one's (within ``rtol``, absolute as much, when given)."""
    batches = _batches()
    plain, want = _run(cfg, batches, cls, **kw)
    with world1():
        sharded, got = _run(cfg, batches, cls, **kw)
        assert sharded.gang and any(
            is_dtensor(p) for p in sharded.model.parameters())
        params = full_state_dict(sharded.model.state_dict())
    assert not plain.gang
    if not rtol:
        assert got == want
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                               rtol=rtol, atol=rtol)
    for k, v in plain.model.state_dict().items():
        torch.testing.assert_close(params[k], v, rtol=rtol, atol=rtol,
                                   msg=k)


@pytest.mark.parametrize("policy", ["dots", "nothing", "everything"])
def test_remat_policies_bit_equal_at_world_1(policy):
    """Each block's recompute gathers it again under fully_shard; the
    saved projection outputs of ``dots`` are the same tensors."""
    _assert_bit_equal(dataclasses.replace(TINY, remat=True,
                                          remat_policy=policy))


def test_attn_out_within_rounding_at_world_1():
    """``attn_out`` calls a block's ``attend`` and ``merge`` apart, each a
    forward of fully_shard's (its own gradient hooks on its inputs), so
    the three gradients that meet at a block's input (the residual and
    the norm's two) are summed in another order than the unwrapped
    model's: the same numbers up to fp32 rounding (measured: 7e-7 on an
    embedding entry of 4.3 after 3 steps), not bit for bit."""
    _assert_bit_equal(dataclasses.replace(TINY, remat=True,
                                          remat_policy="attn_out"),
                      rtol=1e-6)


FAMILIES = {
    "mixtral_einsum": dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral_tiny"], moe_dispatch="einsum", **F32),
    "mixtral_sorted": dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral_tiny"], moe_dispatch="sorted", **F32),
    "gemma2": dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"], **F32),
    "deepseek_moe": dataclasses.replace(DEEPSEEK_CONFIGS["deepseek_moe_tiny"],
                                        **F32),
    "llama_lora": dataclasses.replace(TINY, lora_rank=4),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_bit_equal_at_world_1(family):
    _assert_bit_equal(FAMILIES[family])


@pytest.mark.parametrize("kw", [{"adam_mu_dtype": "bfloat16"},
                                {"grad_accum": 2}],
                         ids=["adam_mu_bf16", "grad_accum2"])
def test_optimizer_forms_bit_equal_at_world_1(kw):
    _assert_bit_equal(TINY, **kw)


def test_dpo_bit_equal_at_world_1():
    """The reference is a frozen copy, gathered whole then sharded."""
    import numpy as np

    batches = _batches()
    for b in batches:
        b["loss_mask"] = np.broadcast_to(np.arange(17) >= 8,
                                         (8, 17)).astype(np.int32).copy()
    plain, want = _run(TINY, batches, DPOTrainer)
    with world1():
        sharded, got = _run(TINY, batches, DPOTrainer)
        assert isinstance(sharded.ref_model, FSDPModule)
        assert is_dtensor(sharded.ref_model.layers[0].attn.q.weight)
    assert plain.ref_model is not None and got == want


@pytest.mark.parametrize("mu", [None, "bfloat16"], ids=["fused", "mu_bf16"])
def test_stop_checkpoint_and_resume_at_world_1(tmp_path, mu):
    """A request()ed stop goes through should_stop's all-reduce, the
    forced save gathers the sharded state (checksums of the whole
    tensors) and a sharded resume of it steps as the unbroken run."""
    batches = _batches()
    _, want = _run(TINY, batches, adam_mu_dtype=mu)
    ckpt = str(tmp_path / "ckpt")
    with world1():
        tr = Trainer(TINY, TrainerConfig(**KW, adam_mu_dtype=mu,
                                         checkpoint_dir=ckpt,
                                         checkpoint_every=1000), device="cpu")
        tr.init_state(seed=0)
        sd = GracefulShutdown(signals=())
        tr.run(iter(batches), model_flops_per_token=1.0,
               on_metrics=lambda m: sd.request(), shutdown=sd)
        assert tr.preempted and tr.step == 1
        assert CheckpointManager(ckpt).all_steps() == [1]
        resumed = Trainer(TINY, TrainerConfig(**KW, adam_mu_dtype=mu,
                                              checkpoint_dir=ckpt),
                          device="cpu")
        assert resumed.maybe_restore() and resumed.step == 1
        assert resumed.gang
        rec = []
        step = resumed.train_step
        resumed.train_step = lambda b: rec.append(step(b)) or rec[-1]
        resumed.run(iter(batches[1:]), model_flops_per_token=1.0)
    assert [(float(m["loss"]), float(m["grad_norm"])) for m in rec] \
        == want[1:]


def test_evaluate_is_the_global_batchs_at_world_1():
    data = _batches(2, seed=9)
    plain = Trainer(TINY, TrainerConfig(**KW), device="cpu")
    plain.init_state(seed=0)
    want = plain.evaluate(iter(data))
    with world1():
        sharded = Trainer(TINY, TrainerConfig(**KW), device="cpu")
        sharded.init_state(seed=0)
        got = sharded.evaluate(iter(data))
    assert got == want


def _grpo_run():
    tr = GRPOTrainer(TINY, TrainerConfig(**{**KW, "seq_len": 24,
                                            "total_steps": 2}),
                     device="cpu", grpo=GRPOConfig(
                         group_size=4, max_new_tokens=6, kl_beta=0.1))
    tr.init_state(seed=0)
    history = tr.run_rl([[7, 8, 9], [11, 12]], lambda p, c: np.array(
        [len(set(x)) for x in c], np.float32), seed=0)
    keys = ("loss", "grad_norm", "kl", "mean_ratio", "reward_mean")
    return [[h[k] for k in keys] for h in history], tr


def _embed_run():
    tr = EmbeddingTrainer(TINY, TrainerConfig(**KW), device="cpu",
                          contrastive=ContrastiveConfig(pooling="last"))
    tr.init_state(seed=0)
    metrics = [[float(v) for v in tr.train_step(
        dict(b, segment_ids=np.ones_like(b["tokens"]))).values()]
        for b in _batches()]
    return metrics, tr


def _vision_run(cfg):
    tr = VisionTrainer(cfg, VisionTrainerConfig(
        batch_size=4, image_size=32, num_classes=10, total_steps=3, lr=0.05,
        warmup_steps=1, handle_preemption=False), device="cpu")
    tr.init_state(seed=0)
    history = tr.run(synthetic_images(4, 32, 10), flops_per_image=1.0)
    return [(m.loss, m.step) for m in history], tr


OBJECTIVES = {
    "grpo": _grpo_run,
    "embed": _embed_run,
    "vit": lambda: _vision_run(ViTConfig(
        image_size=32, patch_size=8, num_classes=10, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, dtype=torch.float32)),
    "resnet": lambda: _vision_run(ResNetConfig(
        num_classes=10, stage_sizes=(1, 1), width=8, dtype=torch.float32)),
}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_whole_batch_objectives_bit_equal_at_world_1(name):
    """GRPO (the decode view over the rank's own shards, the rollout's
    rows, a frozen reference copy), contrastive training (the gathered
    negatives), ViT and ResNet (BatchNorm's statistics, every block
    sharded): a world-1 gang's numbers and final state are the
    unwrapped run's bit for bit."""
    want, plain = OBJECTIVES[name]()
    with world1():
        got, sharded = OBJECTIVES[name]()
        assert sharded.gang and any(
            is_dtensor(p) for p in sharded.model.parameters())
        state = full_state_dict(sharded.model.state_dict())
    assert not plain.gang and got == want
    for k, v in plain.model.state_dict().items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("cls", [GRPOTrainer, EmbeddingTrainer,
                                 VisionTrainer])
@pytest.mark.parametrize("axis", ["sequence", "pipe"])
def test_whole_batch_objectives_refuse_split_rows(monkeypatch, cls, axis):
    """In a gang of two (the world size the refusal reads), a sequence or
    pipe axis raises before any mesh is built."""
    from tpufw_torch.train import sharding

    cfg = (VisionTrainerConfig() if cls is VisionTrainer
           else TrainerConfig(batch_size=8))
    monkeypatch.setattr(sharding, "world_size", lambda: 2)
    with world1(), pytest.raises(NotImplementedError, match=(
            rf"^{cls.__name__} over a {axis} mesh axis of size 2: .* "
            r"\(ROADMAP.md Queue 1 item 12f\)$")):
        cls(TINY, cfg, MeshConfig(**{axis: 2, "fsdp": -1}), device="cpu")


def test_grad_accum_must_divide_over_the_gang():
    """tpufw's rule and wording: each microbatch's rows divide over data
    x fsdp (then a rank's strided microbatch is its part of the global
    one)."""
    with world1():
        tr = Trainer(TINY, TrainerConfig(batch_size=8, grad_accum=3),
                     device="cpu")
        with pytest.raises(ValueError, match=r"^grad_accum=3: batch 8 must "
                           r"split into 3 microbatches whose rows divide "
                           r"over data x fsdp = 1$"):
            tr.check_grad_accum()


def test_meter_counts_per_gpu(monkeypatch):
    """tokens/s/GPU and MFU divide by the gang's device count, as
    tpufw's n_chips does."""
    from tpufw_torch.train import Meter
    from tpufw_torch.train import metrics
    from tpufw_torch.utils.hardware import CHIP_SPECS

    clock = iter([0.0, 2.0, 0.0, 2.0])
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(clock))
    out = []
    for n in (1, 4):
        m = Meter(tokens_per_step=8000, flops_per_token=6.0,
                  chip=CHIP_SPECS["cpu"], n_gpus=n)
        m.start()
        out.append(m.stop(1, 1.0))
    assert out[0].tokens_per_sec_per_gpu == 4000.0
    assert out[1].tokens_per_sec_per_gpu == 1000.0
    assert out[1].mfu == pytest.approx(out[0].mfu / 4)


def test_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(TINY, TrainerConfig(), MeshConfig(data=2, fsdp=1),
                device="cpu")
    with world1(), pytest.raises(ValueError, match="1 devices not divisible"):
        Trainer(TINY, TrainerConfig(), MeshConfig(fsdp=2, tensor=-1),
                device="cpu")
    with pytest.raises(TypeError, match="device="):
        Trainer(TINY, TrainerConfig(), "cpu")
