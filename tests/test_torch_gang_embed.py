"""The port's contrastive training as a 2-process gloo gang at ``fsdp=2``
against ``tpufw``'s ``EmbeddingTrainer`` on ``MeshConfig(data=8)`` over the
same global batches (its virtual devices), from the same Flax weights,
for both published recipes (E5-Mistral: causal, last-token pooling;
LLM2Vec: ``causal=False``, mean pooling), 3 steps. Each rank embeds the
pairs of its half of every global batch and gathers every rank's pooled
vectors, so the in-batch negatives are the global batch's.

Held: the losses, accuracy, sim_pos, sim_neg and grad norms within rtol
1e-4 of ``tpufw``'s and the gathered parameters within 2e-4; against the
port's one-process trainer on the global batch, the same within 1e-5 (a
gradient off by the world size shows in the grad norm, which Adam would
hide from the losses); both ranks report the same global metrics; the
one-process ``embed`` refuses a gang; and ``python -m
tpufw_torch.workloads.embed`` runs as the same gang, each rank on its
batch shard of the pairs. The gang (``tests/torch_gang_worker.py``)
imports no JAX; this process computes the references while it runs."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_gang import (
    WORKER,
    finish,
    read_outputs,
    start_gang,
    write_case,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import contrastive as j_con
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import TrainerConfig
from tpufw_torch.train import contrastive as con
from tpufw_torch.train.sft import byte_encode

# recipe: (preset, causal, pooling, temperature).
RECIPES = {"e5_mistral": ("mistral_tiny", True, "last", 0.02),
           "llm2vec": ("llama3_tiny", False, "mean", 0.05)}
KW = dict(batch_size=8, seq_len=24, total_steps=3, lr=5e-3, warmup_steps=1)
METRICS = ("loss", "accuracy", "sim_pos", "sim_neg", "grad_norm")


def _pairs_file(path, n=12):
    rows = [{"query": f"what is topic {i}" + "?" * (i % 4),
             "positive": f"topic {i} is item number {i} " * (1 + i % 3)}
            for i in range(n)]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


def _cfgs(recipe):
    name, causal, _, _ = RECIPES[recipe]
    window = {} if causal else {"sliding_window": None}
    jc = dataclasses.replace(J_CONFIGS[name], dtype=jnp.float32,
                             causal=causal, **window)
    tc = dataclasses.replace(LLAMA_CONFIGS[name], dtype=torch.float32,
                             causal=causal, **window)
    return jc, tc


def _conf(recipe):
    _, _, pooling, temp = RECIPES[recipe]
    return dict(pooling=pooling, temperature=temp)


def _one_process(tc, state, batches, recipe):
    tr = con.EmbeddingTrainer(tc, TrainerConfig(**KW), device="cpu",
                              contrastive=con.ContrastiveConfig(
                                  **_conf(recipe)))
    tr.init_state(state_dict=state)
    out = [{k: float(v) for k, v in tr.train_step(b).items()}
           for b in batches]
    return out, {k: v.clone() for k, v in tr.model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang_embed")
    path = _pairs_file(tmp / "pairs.jsonl")
    batches = list(con.pair_batches(path, 4, 24, byte_encode, seed=2,
                                    epochs=2))[:3]
    jts, paths = {}, []
    for recipe in RECIPES:
        jc, tc = _cfgs(recipe)
        jt = j_con.EmbeddingTrainer(
            JLlama(jc), JTrainerConfig(**KW), JMeshConfig(data=8),
            contrastive=j_con.ContrastiveConfig(**_conf(recipe)))
        jt.init_state(seed=0)
        state = params_from_flax(jax.device_get(jt.state.params), tc)
        jts[recipe] = (jt, tc, state)
        paths.append(write_case(
            tmp / f"{recipe}.pt", recipe, tc, KW, {"data": 1, "fsdp": 2},
            state, batches, kind="embed", contrastive=_conf(recipe)))
    workload = write_case(
        tmp / "workload.pt", "workload", None, {}, {}, {}, [],
        kind="workload", module="embed", env=dict(
            DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE=8, SEQ_LEN=24,
            TOTAL_STEPS=2, WARMUP_STEPS=1, EMBED_DATA=path,
            BIDIRECTIONAL=1, POOLING="mean", HANDLE_PREEMPTION=0))
    procs = start_gang([WORKER, *paths, workload])
    try:
        want, one = {}, {}
        for recipe, (jt, tc, state) in jts.items():
            step = jt.compiled_step(batches[0])
            metrics = []
            for b in batches:
                jt.state, m = step(jt.state, b)
                metrics.append({k: float(m[k]) for k in METRICS})
            want[recipe] = (metrics, params_from_flax(
                jax.device_get(jt.state.params), tc))
            one[recipe] = _one_process(tc, state, batches, recipe)
    finally:
        outs = finish(procs)
    got = {recipe: read_outputs(p) for recipe, p in zip(RECIPES, paths)}
    return got, want, one, [out for out, _ in outs]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_gang_matches_tpufw_global_batch(runs, recipe):
    got, want, _, _ = runs
    metrics, params = want[recipe]
    for k in METRICS:
        np.testing.assert_allclose(
            [m[k] for m in got[recipe][0]["metrics"]],
            [m[k] for m in metrics], rtol=1e-4, atol=1e-6, err_msg=k)
    gathered = got[recipe][0]["params"]
    assert gathered.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(gathered[k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_gang_matches_one_process(runs, recipe):
    """Within 1e-5 of one process on the global batch, grad norms too:
    the gather's backward sums the ranks' gradients and
    ``backward_global_mean`` weighs each rank's copy of the loss by its
    half of the pairs, so FSDP's average is the global gradient."""
    got, _, one, _ = runs
    metrics, params = one[recipe]
    for k in METRICS:
        np.testing.assert_allclose(
            [m[k] for m in got[recipe][0]["metrics"]],
            [m[k] for m in metrics], rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in params.items():
        np.testing.assert_allclose(got[recipe][0]["params"][k].numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_ranks_report_the_global_metrics(runs, recipe):
    got, _, _, _ = runs
    assert got[recipe][0]["metrics"] == got[recipe][1]["metrics"]
    assert all(o["embed_refusal"] and "one process" in o["embed_refusal"]
               for o in got[recipe])


def test_embed_workload_runs_as_a_gang(runs):
    """Both ranks print the same 2 global losses over fsdp=2, and the
    one-process retrieval probe is left out."""
    stdout = runs[3]
    losses = []
    for out in stdout:
        assert "mesh={'data': 1, 'fsdp': 2, 'sequence': 1}" in out
        assert "EMBED OK: 2 steps" in out
        assert "probe_sim_matched" not in out
        steps = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"step"')]
        assert [s["step"] for s in steps] == [1, 2]
        losses.append([s["loss"] for s in steps])
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))
