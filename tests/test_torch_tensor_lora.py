"""LoRA under the tensor and expert axes: the adapters ride their weight's
split (a column weight's B cut with its rows, a row weight's A with its
columns, an expert stack's adapters with its experts and its width; the
rank axis whole). The port's ``Trainer`` with ``lora_rank=4`` over one
process's local groups against ``tpufw``'s Trainer on the same axes (its
8 virtual devices), from the same Flax weights, in fp32, 2 steps with no
warm-up (so the second step's A gradients are not zero): ``llama3_tiny``
at ``tensor=2`` and ``mixtral_tiny`` at ``expert=2 x tensor=2``.

- losses within rtol 1e-4 and the trained adapters within 2e-4 of
  ``tpufw``'s, the frozen base unchanged on both sides, and the grad
  norms (the adapters', which the port reports) within 2e-4 of the
  unsplit run's;
- every adapter's gradient of the objective at ``tpufw``'s trained
  weights within 2e-4 of ``jax.grad`` of ``tpufw``'s ``batch_loss``
  there, and the base given none;
- ``merge_lora`` of the split run's whole state equals the unsplit run's
  merge (1e-5);
- a 2-rank gloo gang (``tensor=2`` Llama, ``expert=2`` Mixtral, and
  ``train_llama`` under ``TPUFW_LORA_RANK`` with ``TPUFW_MESH_TENSOR``)
  within 1e-5 of one process: losses, grad norms, every adapter's
  gathered gradient, and the adapters saved whole."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_gang import (
    WORKER,
    finish,
    global_batches,
    read_outputs,
    start_gang,
    write_case,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import (
    BATCH,
    KW,
    SEQ,
    batches,
    jax_train,
    jax_trainer,
    local_groups,
    port_run,
)
import tpufw.models as J_MODELS
import tpufw_torch.models as T_MODELS
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models.lora import is_lora_name, merge_lora
from tpufw_torch.parallel import use_groups

RANK, STEPS = 4, 2
LORA_KW = dict(total_steps=STEPS, warmup_steps=0)
# name: (preset table, preset, tpufw's mesh, one process's (expert,
# tensor)).
CASES = {
    "llama_tensor2": ("LLAMA_CONFIGS", "llama3_tiny",
                      {"data": 2, "fsdp": 2, "tensor": 2}, (1, 2)),
    "mixtral_expert2_tensor2": ("MIXTRAL_CONFIGS", "mixtral_tiny",
                                {"data": 1, "fsdp": 2, "expert": 2,
                                 "tensor": 2}, (2, 2)),
}
# The 2-rank gang: name: (case of CASES, the gang's mesh).
GANG = {"llama_tensor2": ("llama_tensor2", {"tensor": 2, "fsdp": 1}),
        "mixtral_expert2": ("mixtral_expert2_tensor2",
                            {"expert": 2, "fsdp": 1})}
GANG_KW = dict(KW, **LORA_KW, batch_size=BATCH, loss_chunk_size=8,
               loss_chunk_dtype="float32")
WORKLOAD_ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE=4,
                    SEQ_LEN=SEQ, TOTAL_STEPS=STEPS, LR="1e-3",
                    WARMUP_STEPS=0, LOSS_CHUNK_SIZE=8,
                    LOSS_CHUNK_DTYPE="float32", LORA_RANK=RANK,
                    MESH_FSDP=1)


def _pair(name):
    table, preset = CASES[name][:2]
    f32 = dict(lora_rank=RANK)
    return (dataclasses.replace(getattr(J_MODELS, table)[preset],
                                dtype=jnp.float32, param_dtype=jnp.float32,
                                **f32),
            dataclasses.replace(getattr(T_MODELS, table)[preset],
                                dtype=torch.float32,
                                param_dtype=torch.float32, **f32))


def _jax_grads(jcfg, tcfg, jparams, batch) -> dict:
    """``jax.grad`` of ``tpufw``'s objective at ``jparams`` on ``batch``,
    as the port's state dict."""
    from tpufw.models import model_for_config as j_model_for_config
    from tpufw.train.trainer import batch_loss as j_batch_loss

    model = j_model_for_config(jcfg)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: j_batch_loss(model.apply, p, b)[0]))(
        jparams)
    return params_from_flax(jax.device_get(grads), tcfg)


def _port_grads(tcfg, state, batch, groups) -> dict:
    """Every parameter's gradient (None for the frozen base) of the
    port's objective at ``state`` over one process's ``groups``."""
    from tpufw_torch.models import model_for_config
    from tpufw_torch.train.trainer import batch_loss

    model = model_for_config(tcfg, device="cpu")
    model.load_state_dict(state)
    with use_groups(**{g.axis: g for g in groups}):
        loss, _ = batch_loss(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The 2-rank gang's outputs, started first and read last: {name: each
    rank's output}, the one-process references, the workload's stdouts."""
    tmp = tmp_path_factory.mktemp("tensor_lora")
    data = global_batches(BATCH, SEQ, STEPS)
    paths, states = {}, {}
    for name, (case, mesh) in GANG.items():
        tcfg = _pair(case)[1]
        states[name] = T_MODELS.model_for_config(
            tcfg, device="cpu").state_dict()
        paths[name] = write_case(
            tmp / f"{name}.pt", name, tcfg,
            dict(GANG_KW, handle_preemption=False), mesh, states[name],
            data, grads=True)
    work = {n: write_case(tmp / f"workload_{n}.pt", "workload", None, {},
                          {}, {}, [], kind="workload", module="train_llama",
                          env=dict(WORKLOAD_ENV, **extra))
            for n, extra in (("gang", {"MESH_TENSOR": 2}), ("one", {}))}
    procs = start_gang([WORKER, *paths.values(), work["gang"]])
    one = start_gang([WORKER, work["one"]], world=1)
    yield procs, one, paths, states, data


@pytest.fixture(scope="module")
def runs(gang, devices8):
    out = {}
    for name, (_, _, mesh, (ep, tp)) in CASES.items():
        jcfg, tcfg = _pair(name)
        data = batches(tcfg, batch=BATCH)[:STEPS]
        jt, init = jax_trainer(jcfg, tcfg, mesh, BATCH, **LORA_KW)
        want = jax_train(jt, tcfg, data)
        jparams = jax.device_get(meta.unbox(jt.state.params))
        groups = local_groups(ep, tp)
        got = port_run(tcfg, init, data, groups, **LORA_KW)
        whole = port_run(tcfg, init, data, (), **LORA_KW)
        grads = (_jax_grads(jcfg, tcfg, jparams, data[0]),
                 _port_grads(tcfg, want[2], data[0], groups))
        out[name] = init, want, got, whole, grads
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_lora_trains_as_tpufw(runs, name):
    init, (j_losses, _, j_final), (losses, norms, final), whole, _ = \
        runs[name]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    # The port's grad_norm is the adapters' (tpufw's counts the base's
    # gradients too): held to the unsplit run's.
    np.testing.assert_allclose(norms, whole[1], rtol=2e-4)
    assert final.keys() == j_final.keys() == init.keys()
    moved = 0
    for k, v in final.items():
        if is_lora_name(k):
            np.testing.assert_allclose(v.numpy(), j_final[k].numpy(),
                                       rtol=2e-4, atol=2e-4, err_msg=k)
            moved += not torch.equal(v, init[k])
        else:
            assert torch.equal(v, init[k]), k
            np.testing.assert_array_equal(j_final[k].numpy(),
                                          init[k].numpy(), err_msg=k)
    assert moved == sum(map(is_lora_name, init))


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_adapter_grads_match_tpufw(runs, name):
    j_grads, grads = runs[name][4]
    n_adapters = 0
    for k, g in grads.items():
        if not is_lora_name(k):
            assert g is None, k
            continue
        n_adapters += 1
        assert float(g.abs().max()) > 0, k
        np.testing.assert_allclose(g.numpy(), j_grads[k].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    assert n_adapters > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_equals_unsplit_merge(runs, name):
    tcfg = _pair(name)[1]
    split, whole = runs[name][2][2], runs[name][3][2]
    got = merge_lora(split, alpha=tcfg.lora_alpha)
    want = merge_lora(whole, alpha=tcfg.lora_alpha)
    assert got.keys() == want.keys()
    assert not any(map(is_lora_name, got))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def gang_outputs(gang, runs):
    procs, one, paths, _, _ = gang
    outs = finish(procs, timeout=240)
    (one_process, _), = finish(one, timeout=240)
    return ({name: read_outputs(p) for name, p in paths.items()}, outs,
            one_process)


def _one_process(name, state, data):
    from tests.torch_gang_worker import objective_grads
    from tpufw_torch.train import Trainer, TrainerConfig

    case = GANG[name][0]
    tr = Trainer(_pair(case)[1], TrainerConfig(
        **GANG_KW, handle_preemption=False), device="cpu",
        groups=local_groups(*CASES[case][3]))
    tr.init_state(state_dict=state)
    rec = [tr.train_step(b) for b in data]
    return ([float(m["loss"]) for m in rec],
            [float(m["grad_norm"]) for m in rec],
            {k: v.detach() for k, v in tr.model.state_dict().items()},
            objective_grads(tr, data[0]))


@pytest.mark.parametrize("name", sorted(GANG))
def test_lora_gang_equals_one_process(gang, gang_outputs, name):
    _, _, _, states, data = gang
    outs = gang_outputs[0][name]
    losses, norms, params, grads = _one_process(name, states[name], data)
    assert outs[0]["losses"] == outs[1]["losses"]
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(outs[0]["grad_norms"], norms, rtol=1e-5)
    assert outs[0]["params"].keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(outs[0]["params"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got = outs[0]["grads"]
    for k, g in grads.items():
        if is_lora_name(k):
            np.testing.assert_allclose(got[k].numpy(), g.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            assert g is None and got[k] is None, k


def test_train_llama_lora_workload_trains_as_a_tensor_gang(gang_outputs):
    def losses(stdout):
        return [json.loads(ln)["loss"] for ln in stdout.splitlines()
                if ln.startswith('{"step"')]

    _, outs, one_process = gang_outputs
    want = losses(one_process)
    assert len(want) == STEPS
    for rank, (out, _) in enumerate(outs):
        assert "'tensor': 2" in out
        np.testing.assert_allclose(losses(out), want, rtol=1e-5)
