"""ResNet-50 training workload:
``python -m tpufw_torch.workloads.train_resnet`` (port of
``tpufw.workloads.train_resnet``), on one GPU or as a gang, one process
per GPU (``cluster``), over ``tpufw``'s default mesh (every rank on
``fsdp``; no mesh knob, as in ``tpufw``), BatchNorm's statistics the
global batch's.

Knobs (``TPUFW_*``): ``NORM_DTYPE`` (BatchNorm's output dtype,
``bfloat16`` by default: the early stages are bandwidth-bound),
``BATCH_SIZE`` (256), ``IMAGE_SIZE`` (224), ``NUM_CLASSES`` (1000),
``TOTAL_STEPS`` (50), ``SEED``, ``DEVICE`` (default ``cuda``), and the
checkpoint and preemption set: ``CHECKPOINT_DIR`` (resume from its latest
step at start), ``CHECKPOINT_EVERY`` (100), ``HANDLE_PREEMPTION`` and
``PREEMPTION_SYNC_EVERY``. Synthetic images of the global batch from the
host (each rank feeds its batch shard's rows); one JSON line per step,
then the ``TRAIN OK`` line.
"""

from __future__ import annotations

import json

from tpufw_torch.workloads.env import env_bool, env_int, env_str


def build_trainer(cluster=None):
    """(trainer, model_cfg) from the TPUFW_* environment, on ``cluster``'s
    local device (default: the resolved cluster environment) and sharded
    when a process group is initialized."""
    import torch

    from tpufw_torch.cluster import local_device, resolve_cluster_env
    from tpufw_torch.models import ResNetConfig
    from tpufw_torch.train import VisionTrainer, VisionTrainerConfig

    norm_dtype = env_str("norm_dtype", "bfloat16")
    dtype = getattr(torch, norm_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"TPUFW_NORM_DTYPE={norm_dtype!r} is not a dtype")
    cfg = VisionTrainerConfig(
        batch_size=env_int("batch_size", 256),
        image_size=env_int("image_size", 224),
        num_classes=env_int("num_classes", 1000),
        total_steps=env_int("total_steps", 50),
        checkpoint_dir=env_str("checkpoint_dir", "") or None,
        checkpoint_every=env_int("checkpoint_every", 100),
        handle_preemption=env_bool("handle_preemption", True),
        preemption_sync_every=env_int("preemption_sync_every", 1),
    )
    mcfg = ResNetConfig(num_classes=cfg.num_classes, norm_dtype=dtype)
    device = local_device(cluster or resolve_cluster_env(),
                          env_str("device", "cuda"))
    return VisionTrainer(mcfg, cfg, device=device), mcfg


def main() -> int:
    from tpufw_torch.cluster import initialize_cluster
    from tpufw_torch.train import synthetic_images
    from tpufw_torch.train.vision import batch_rows
    from tpufw_torch.utils.profiling import enable_compile_cache
    from tpufw_torch.workloads._common import report_preemption

    enable_compile_cache()
    cluster = initialize_cluster(device=env_str("device", "cuda"))
    trainer, mcfg = build_trainer(cluster)
    cfg = trainer.cfg
    print(f"tpufw_torch train_resnet: device={trainer.device}", flush=True)
    if trainer.maybe_restore():
        print(f"resumed from checkpoint at step {trainer.step}", flush=True)
    else:
        trainer.init_state(seed=env_int("seed", 0))
    history = trainer.run(
        batch_rows(synthetic_images(cfg.batch_size, cfg.image_size,
                                    cfg.num_classes),
                   *trainer.batch_shard()),
        flops_per_image=mcfg.flops_per_image(cfg.image_size),
        on_metrics=lambda m: print(json.dumps(m.as_dict()), flush=True),
    )
    report_preemption(trainer)
    if history:
        last = history[-1]
        print(f"TRAIN OK: {len(history)} steps, final loss {last.loss:.4f}, "
              f"{last.tokens_per_sec_per_gpu:.1f} images/s/GPU, "
              f"MFU {last.mfu:.1%}")
    if trainer.gang:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
