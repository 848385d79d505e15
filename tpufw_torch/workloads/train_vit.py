"""ViT training workload: ``python -m tpufw_torch.workloads.train_vit``
(port of ``tpufw.workloads.train_vit``), on one GPU or as a gang, one
process per GPU (``cluster``), over ``tpufw``'s default mesh (every rank
on ``fsdp``; no mesh knob, as in ``tpufw``).

Knobs (``TPUFW_*``): ``MODEL`` (``vit_b16``, ``vit_s16`` or ``vit_l16``),
``NUM_CLASSES`` (1000), ``REMAT`` (default: the preset's, on),
``BATCH_SIZE`` (256), ``TOTAL_STEPS`` (50), ``LR_MILLI`` (the learning
rate in thousandths, 1), ``SYNC_EVERY`` (4), ``SEED``, ``DEVICE`` (default
``cuda``), and the checkpoint and preemption set: ``CHECKPOINT_DIR``
(resume from its latest step at start), ``CHECKPOINT_EVERY`` (100),
``HANDLE_PREEMPTION`` and ``PREEMPTION_SYNC_EVERY``. Synthetic images of
the global batch staged on the device once (each rank feeds its batch
shard's rows); one JSON line per metered window, then the ``TRAIN OK``
line.
"""

from __future__ import annotations

import dataclasses
import json

from tpufw_torch.workloads.env import env_bool, env_int, env_str


def build_trainer(cluster=None):
    """(trainer, model_cfg) from the TPUFW_* environment, on ``cluster``'s
    local device (default: the resolved cluster environment) and sharded
    when a process group is initialized."""
    from tpufw_torch.cluster import local_device, resolve_cluster_env
    from tpufw_torch.models import VIT_CONFIGS
    from tpufw_torch.train import VisionTrainer, VisionTrainerConfig

    name = env_str("model", "vit_b16")
    if name not in VIT_CONFIGS:
        raise SystemExit(
            f"TPUFW_MODEL={name!r} unknown; choose from {sorted(VIT_CONFIGS)}")
    mcfg = dataclasses.replace(
        VIT_CONFIGS[name],
        num_classes=env_int("num_classes", 1000),
        remat=env_bool("remat", VIT_CONFIGS[name].remat),
    )
    cfg = VisionTrainerConfig(
        batch_size=env_int("batch_size", 256),
        image_size=mcfg.image_size,
        num_classes=mcfg.num_classes,
        total_steps=env_int("total_steps", 50),
        lr=env_int("lr_milli", 1) / 1000.0,
        checkpoint_dir=env_str("checkpoint_dir", "") or None,
        checkpoint_every=env_int("checkpoint_every", 100),
        handle_preemption=env_bool("handle_preemption", True),
        preemption_sync_every=env_int("preemption_sync_every", 1),
        sync_every=env_int("sync_every", 4),
    )
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
    print(f"tpufw_torch train_vit[{env_str('model', 'vit_b16')}]: "
          f"device={trainer.device} params={mcfg.n_params():,}", flush=True)
    if trainer.maybe_restore():
        print(f"resumed from checkpoint at step {trainer.step}", flush=True)
    else:
        trainer.init_state(seed=env_int("seed", 0))
    history = trainer.run(
        batch_rows(synthetic_images(cfg.batch_size, cfg.image_size,
                                    cfg.num_classes, device=trainer.device),
                   *trainer.batch_shard()),
        flops_per_image=mcfg.flops_per_image(),
        on_metrics=lambda m: print(json.dumps(m.as_dict()), flush=True),
    )
    report_preemption(trainer)
    if history:
        last = history[-1]
        print(f"TRAIN OK: {len(history)} windows, final loss "
              f"{last.loss:.4f}, {last.tokens_per_sec_per_gpu:.1f} "
              f"images/s/GPU, MFU {last.mfu:.1%}")
    if trainer.gang:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
