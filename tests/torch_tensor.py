"""Shared set-up of the tensor and expert parallelism tests: ``tpufw``'s
Trainer on a mesh and the port's over one process's local groups, from
the same Flax weights in fp32, and their comparison at the tolerances of
``tests/conftest.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import meta

from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.models import model_for_config as j_model_for_config
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.interop import params_from_flax
from tpufw_torch.parallel import LocalExpertGroup, LocalTensorGroup, use_groups
from tpufw_torch.train import (
    Trainer,
    TrainerConfig,
    synthetic_batches,
    synthetic_packed_batches,
)

SEQ, STEPS, BATCH = 17, 3, 8
KW = dict(seq_len=SEQ, total_steps=STEPS, lr=1e-3, warmup_steps=1)
TP_MESH = dict(data=2, fsdp=2, tensor=2)


def fp32_pair(jconfigs, tconfigs, name, **over):
    """(JAX config, port config) of preset ``name`` in fp32."""
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    return (dataclasses.replace(jconfigs[name], **f32, **over),
            dataclasses.replace(tconfigs[name], dtype=torch.float32,
                                param_dtype=torch.float32, **over))


def jax_trainer(jcfg, tcfg, mesh: dict, batch_size: int, base=None, **kw):
    """(``tpufw``'s Trainer on ``mesh`` initialized from seed 0, its
    initial params as the port's state dict): TrainerConfig ``base``
    fields, default ``KW``, updated by ``kw``."""
    jt = JTrainer(j_model_for_config(jcfg), JTrainerConfig(
        **{"batch_size": batch_size, **(base or KW), **kw}),
        JMeshConfig(**mesh))
    jt.init_state(seed=0)
    return jt, params_from_flax(jax.device_get(meta.unbox(jt.state.params)),
                                tcfg)


def jax_train(jt, tcfg, batches: list):
    """(losses, grad norms, final port state) of ``tpufw``'s Trainer
    ``jt`` over the global ``batches``; its compiled step is wrapped to
    keep each step's grad_norm."""
    norms, compiled = [], jt.compiled_step

    def recording(b=None):
        step = compiled(b)

        def run(state, gb):
            state, m = step(state, gb)
            norms.append(float(m["grad_norm"]))
            return state, m

        return run

    jt.compiled_step = recording
    hist = jt.run(iter(batches), model_flops_per_token=1.0)
    final = params_from_flax(jax.device_get(meta.unbox(jt.state.params)),
                             tcfg)
    return [m.loss for m in hist], norms, final


def jax_run(jcfg, tcfg, mesh: dict, batches: list, base=None, **kw):
    """(initial port state, losses, grad norms, final port state) of
    ``tpufw``'s Trainer on ``mesh`` over the global ``batches``
    (``jax_trainer``, ``jax_train``)."""
    jt, init = jax_trainer(jcfg, tcfg, mesh, len(batches[0]["tokens"]),
                           base, **kw)
    return (init, *jax_train(jt, tcfg, batches))


def port_run(tcfg, init: dict, batches: list, groups: tuple, **kw):
    """(losses, grad norms, final state) of the port's Trainer over
    ``groups`` in one process."""
    tr = Trainer(tcfg, TrainerConfig(batch_size=len(batches[0]["tokens"]),
                                     **{**KW, **kw}), device="cpu",
                 groups=groups)
    tr.init_state(state_dict=init)
    losses, norms = [], []
    for b in batches:
        m = tr.train_step(b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.detach() for k, v in
                           tr.model.state_dict().items()}


def assert_matches(got, want):
    """Losses rtol 1e-4; grad norms and parameters 2e-4."""
    losses, norms, params = got
    _, j_losses, j_norms, j_params = want
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, j_norms, rtol=2e-4)
    assert params.keys() == j_params.keys()
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), j_params[k].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


def batches(tcfg, packed=False, batch=BATCH, seed=3):
    fn = synthetic_packed_batches if packed else synthetic_batches
    kw = {"mean_doc_len": 6} if packed else {}
    it = fn(batch, SEQ, tcfg.vocab_size, seed=seed, **kw)
    return [next(it) for _ in range(STEPS)]


def local_groups(ep: int, tp: int) -> tuple:
    """One process's expert and tensor groups of those sizes."""
    return tuple(g for g in (LocalExpertGroup(ep), LocalTensorGroup(tp))
                 if g.size > 1)


def assert_grads_unsplit(tcfg, init: dict, batch: dict, groups: tuple):
    """One backward of the objective (router losses included) under
    ``groups`` and unsplit, from ``init``: each parameter's gradient
    within 1e-5 (Adam's update is blind to a gradient's scale, so final
    parameters alone would not show one counted twice)."""
    from tpufw_torch.models import model_for_config
    from tpufw_torch.train.trainer import batch_loss

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for gs in ((), groups):
        model = model_for_config(tcfg, device="cpu")
        model.load_state_dict(init)
        with use_groups(**{g.axis: g for g in gs}):
            loss, _ = batch_loss(model, batch)
            loss.backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    return grads[0]
