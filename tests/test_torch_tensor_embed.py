"""Contrastive embeddings and GRPO over tensor shards: the port's
``EmbeddingTrainer`` on one process's ``LocalTensorGroup(2)`` against
``tpufw``'s on ``MeshConfig(data=2, fsdp=2, tensor=2)``
(``tests/test_contrastive.py``'s mesh) for both published recipes
(E5-Mistral: causal, last-token pooling; LLM2Vec: ``causal=False``, mean
pooling), from the same Flax weights in fp32: losses and metrics at rtol
1e-4, grad norms at 2e-4 (``tests/conftest.py``), then the port alone to
``tpufw``'s separation of the pairs (accuracy 1.0). GRPO has no
reference test over a tensor axis: its split run is held to the port's
unsplit run (the rollouts decode on the whole policy, so their tokens are
equal; losses within 1e-4, grad norms at 2e-4, every step's first ratio
exactly 1)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import tpufw_torch.infer
from tpufw.mesh import MeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import contrastive as j_con
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import TP_MESH
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.parallel import LocalTensorGroup
from tpufw_torch.train import GRPOConfig, GRPOTrainer, TrainerConfig
from tpufw_torch.train import contrastive as con
from tpufw_torch.train.sft import byte_encode
from tpufw_torch.workloads.rl import resolve_reward

METRICS = ("loss", "accuracy", "sim_pos", "sim_neg")
# recipe: (preset, causal, pooling, temperature).
RECIPES = {"e5_mistral": ("mistral_tiny", True, "last", 0.02),
           "llm2vec": ("llama3_tiny", False, "mean", 0.05)}


def _pairs_file(path, n=9):
    rows = [{"query": f"what is topic {i}" + "?" * (i % 4),
             "positive": f"topic {i} is item number {i} " * (1 + i % 3)}
            for i in range(n)]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_embedding_trainer_over_tensor_shards_matches_tpufw(
        tmp_path, devices8, recipe):
    """Both recipes pool the replicated hidden states after the last
    row-parallel exit and the final norm: 3 steps of ``tpufw``'s metrics
    and grad norms on its tensor mesh, then, on one repeated batch, the
    pairs separate (``tests/test_contrastive.py``'s anchor)."""
    name, causal, pooling, temp = RECIPES[recipe]
    window = {} if causal else {"sliding_window": None}
    jc = dataclasses.replace(J_CONFIGS[name], dtype=jnp.float32,
                             causal=causal, **window)
    tc = dataclasses.replace(LLAMA_CONFIGS[name], dtype=torch.float32,
                             causal=causal, **window)
    kw = dict(batch_size=8, seq_len=24, total_steps=10, lr=5e-3,
              warmup_steps=1)
    jt = j_con.EmbeddingTrainer(
        JLlama(jc), JTrainerConfig(**kw), MeshConfig(**TP_MESH),
        contrastive=j_con.ContrastiveConfig(pooling=pooling,
                                            temperature=temp))
    jt.init_state(seed=0)
    tt = con.EmbeddingTrainer(tc, TrainerConfig(**kw), device="cpu",
                              contrastive=con.ContrastiveConfig(
                                  pooling=pooling, temperature=temp),
                              groups=(LocalTensorGroup(2),))
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(meta.unbox(jt.state.params)), tc))
    batches = list(con.pair_batches(_pairs_file(tmp_path / "p.jsonl"), 4,
                                    24, byte_encode, seed=2, epochs=2))[:3]
    step = jt.compiled_step(batches[0])
    for batch in batches:
        jt.state, jm = step(jt.state, jt.globalize_batch(batch))
        tm = tt.train_step(batch)
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
    first = float(tt.train_step(batches[0])["loss"])
    for _ in range(6):
        last = tt.train_step(batches[0])
    assert float(last["loss"]) < first
    assert float(last["accuracy"]) == 1.0
    assert float(last["sim_pos"]) > float(last["sim_neg"])


def test_grpo_over_tensor_shards_matches_unsplit(monkeypatch):
    """Two GRPO steps with a KL term, unsplit and over two tensor shards,
    from seed 0: the same rollout tokens (decoded on the whole policy),
    the scoring and the update through the vocab-parallel log-probs (each
    step's first ratio exactly 1), the reference cut as the policy is;
    losses, KL and grad norms the unsplit run's."""
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                              dtype=torch.float32)
    runs = {}
    generate = tpufw_torch.infer.generate
    for groups in ((), (LocalTensorGroup(2),)):
        tokens = []

        def recorded(*a, tokens=tokens, **k):
            tokens.append(generate(*a, **k).clone())
            return tokens[-1]

        monkeypatch.setattr(tpufw_torch.infer, "generate", recorded)
        tr = GRPOTrainer(cfg, TrainerConfig(
            batch_size=8, seq_len=24, total_steps=2, lr=1e-3,
            warmup_steps=0, loss_chunk_size=8, loss_chunk_dtype="float32",
            handle_preemption=False), device="cpu",
            grpo=GRPOConfig(group_size=4, max_new_tokens=8, kl_beta=0.02,
                            ref_dtype="float32"), groups=groups)
        tr.init_state(seed=0)
        hist = tr.run_rl([[5, 6, 7], [8, 9]],
                         resolve_reward("low_token", cfg.vocab_size, 8),
                         seed=0)
        runs[len(groups)] = (hist, tokens)
    (split, split_toks), (whole, whole_toks) = runs[1], runs[0]
    assert len(split) == 2 and all(
        torch.equal(a, b) for a, b in zip(split_toks, whole_toks))
    assert all(h["mean_ratio"] == 1.0 for h in split)
    for k in ("loss", "kl"):
        np.testing.assert_allclose([h[k] for h in split],
                                   [h[k] for h in whole], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose([h["grad_norm"] for h in split],
                               [h["grad_norm"] for h in whole], rtol=2e-4)
