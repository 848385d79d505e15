"""Embedding fine-tuning workload: ``python -m tpufw_torch.workloads.embed``
(port of ``tpufw.workloads.embed``): contrastive pairs -> an encoder. One
JSON line a step (the InfoNCE loss), then, in one process, a retrieval
probe: the matched and mismatched cosine similarity of the first pairs.
On one GPU or as a gang, one process per GPU (``cluster``): each rank
feeds the pairs of its batch shard, and the in-batch negatives are the
global batch's.

Knobs (``TPUFW_*``):
  MODEL (a ``LLAMA_CONFIGS`` preset, default ``llama3_tiny``) /
  INIT_FROM / SEED / DEVICE (default ``cuda``)
  EMBED_DATA     JSONL {"query", "positive"} pairs (required)
  SFT_TOKENIZER  "bytes" (default) or a local tokenizer directory
  POOLING        "mean" (default) or "last"
  BIDIRECTIONAL  1: LLM2Vec-style ``causal=False`` (the window dropped);
                 default 0, E5-style causal
  TEMPERATURE    the InfoNCE temperature (0.05)
  BATCH_SIZE (rows, two a pair) / SEQ_LEN / TOTAL_STEPS / LR /
  WARMUP_STEPS / LOG_EVERY / CHECKPOINT_DIR / CHECKPOINT_EVERY / DATA_SEED
  MESH_DATA / MESH_FSDP (-1: fill) / MESH_TENSOR   the mesh, as
                 ``tpufw``'s; TENSOR above 1 splits the heads, MLP widths
                 and vocabulary over that many ranks of the gang
"""

from __future__ import annotations

import dataclasses
import json
import time

from tpufw_torch.workloads.env import (
    batch_mesh_from_env,
    env_bool,
    env_float,
    env_int,
    env_str,
)

_T0 = time.time()


def build_trainer(cluster=None):
    """(trainer, model_cfg) from the TPUFW_* env, on ``cluster``'s local
    device (default: the resolved cluster environment) and sharded over
    the process group's mesh when one is initialized."""
    from tpufw_torch.cluster import local_device, resolve_cluster_env
    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.train import TrainerConfig
    from tpufw_torch.train.contrastive import (
        ContrastiveConfig,
        EmbeddingTrainer,
    )

    mesh_cfg = batch_mesh_from_env()
    name = env_str("model", "llama3_tiny")
    if name not in LLAMA_CONFIGS:
        raise ValueError(
            f"unknown TPUFW_MODEL={name!r}; embedding workload presets: "
            f"{sorted(LLAMA_CONFIGS)}")
    model_cfg = LLAMA_CONFIGS[name]
    if env_bool("bidirectional", False):
        model_cfg = dataclasses.replace(model_cfg, causal=False,
                                        sliding_window=None)
    trainer_cfg = TrainerConfig(
        batch_size=env_int("batch_size", 16),
        seq_len=env_int("seq_len", min(512, model_cfg.max_seq_len)),
        total_steps=env_int("total_steps", 100),
        lr=env_float("lr", 2e-5),
        warmup_steps=env_int("warmup_steps", 10),
        checkpoint_dir=env_str("checkpoint_dir", "") or None,
        checkpoint_every=env_int("checkpoint_every", 100),
        log_every=env_int("log_every", 1),
    )
    device = local_device(cluster or resolve_cluster_env(),
                          env_str("device", "cuda"))
    trainer = EmbeddingTrainer(
        model_cfg, trainer_cfg, mesh_cfg, device=device,
        contrastive=ContrastiveConfig(
            temperature=env_float("temperature", 0.05),
            pooling=env_str("pooling", "mean")))
    return trainer, model_cfg


def embed_flops_per_token(model_cfg, seq_len: int) -> float:
    """Train FLOPs a token of the encoder: the 6N count less the LM
    head's 6·D·V (InfoNCE has no head), plus, for a bidirectional trunk,
    the attention scores' other half (``flops_per_token`` counts causal
    attention, half the keys)."""
    flops = (model_cfg.flops_per_token(seq_len - 1)
             - 6.0 * model_cfg.d_model * model_cfg.vocab_size)
    if not getattr(model_cfg, "causal", True):
        flops += model_cfg._attn_score_flops(seq_len - 1)
    return flops


def main() -> int:
    import numpy as np

    from tpufw_torch.cluster import initialize_cluster
    from tpufw_torch.train.contrastive import _fit, pair_batches, read_pairs
    from tpufw_torch.utils.profiling import enable_compile_cache
    from tpufw_torch.workloads._common import (
        check_global_batch,
        metrics_printer,
        report_preemption,
        resolve_encode,
        resume_data_seed,
    )

    cache = enable_compile_cache()
    cluster = initialize_cluster(device=env_str("device", "cuda"))
    trainer, model_cfg = build_trainer(cluster)
    mesh = (dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
            if trainer.gang else {})
    print(f"tpufw_torch embed: process {cluster.process_id}/"
          f"{cluster.num_processes} rank {cluster.rank}/{cluster.world_size} "
          f"device={trainer.device} mesh={mesh} "
          f"params={model_cfg.n_params():,} "
          f"pooling={trainer.contrastive.pooling} "
          f"causal={getattr(model_cfg, 'causal', True)}"
          + (f" compile_cache={cache}" if cache else ""), flush=True)
    if trainer.maybe_restore():
        print(f"resumed from checkpoint at step {trainer.step}", flush=True)
    else:
        init_from = env_str("init_from", "")
        if init_from:
            trainer.init_from_params(init_from, seed=env_int("seed", 0))
            print(f"initialized params from {init_from}", flush=True)
        else:
            trainer.init_state(seed=env_int("seed", 0))
    cfg = trainer.cfg
    shard, n_shards = trainer.batch_shard()
    local_bs = check_global_batch(cfg.batch_size, n_shards)
    if local_bs % 2:
        raise ValueError(
            f"embedding local batch {local_bs} must be even (2 rows/pair)")
    data_path = env_str("embed_data", "")
    if not data_path:
        raise ValueError(
            "TPUFW_EMBED_DATA is required: JSONL "
            '{"query": ..., "positive": ...} pairs')
    encode = resolve_encode(env_str("sft_tokenizer", "bytes"))
    data = pair_batches(
        data_path, local_bs // 2, cfg.seq_len, encode,
        seed=resume_data_seed(env_int("data_seed", 0), trainer.step),
        shard_id=shard, num_shards=n_shards)
    history = trainer.run(
        data, model_flops_per_token=embed_flops_per_token(model_cfg,
                                                          cfg.seq_len),
        on_metrics=metrics_printer(_T0))
    report_preemption(trainer)
    if history and not trainer.gang:
        # The retrieval probe, one process's surface (as in tpufw): the
        # first 4 pairs, rows fitted as in training.
        probe = []
        for i, p in enumerate(read_pairs(data_path)):
            if i >= 4:
                break
            probe.append(p)
        toks = np.zeros((2 * len(probe), cfg.seq_len), np.int32)
        seg = np.zeros_like(toks)
        for i, p in enumerate(probe):
            toks[2 * i], seg[2 * i] = _fit(encode(p["query"]), cfg.seq_len)
            toks[2 * i + 1], seg[2 * i + 1] = _fit(encode(p["positive"]),
                                                   cfg.seq_len)
        emb = trainer.embed(toks, seg)
        sim = emb[0::2] @ emb[1::2].T
        print(json.dumps({
            "probe_sim_matched": round(float(np.diag(sim).mean()), 4),
            "probe_sim_mismatched": round(float(
                (sim.sum() - np.diag(sim).sum())
                / max(sim.size - len(probe), 1)), 4),
        }), flush=True)
    if history:
        print(f"EMBED OK: {len(history)} steps, final loss "
              f"{history[-1].loss:.4f}", flush=True)
    if trainer.gang:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
