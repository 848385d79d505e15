"""ViT and ResNet under the tensor axis: the port's ``VisionTrainer`` at
``MeshConfig(tensor=2, fsdp=1)`` in one process (a ``LocalTensorGroup``:
ViT's q/k/v and up column-parallel, o and down row-parallel, each shard
attending with its heads; both families' class head vocab-parallel, the
cross-entropy over the class shards; ResNet's convolutions and
BatchNorm replicated) against ``tpufw``'s ``VisionTrainer`` on
``MeshConfig(data=2, fsdp=2, tensor=2)`` (its 8 virtual devices), from
the same Flax weights, tiny models in fp32, 3 steps on the global
batches of ``synthetic_images``: losses within rtol 1e-4, the final
parameters and BatchNorm running statistics within 2e-4. ``tpufw``
keeps ViT's k and v whole (their ``"kv"`` axis maps to no mesh axis);
the port splits them with q, the same numbers (a divergence by design).

A 2-rank gloo gang at ``tensor=2`` (each rank its shards, both feeding
every row; ``tests/torch_gang_worker.py``, no JAX) against one unsplit
process: losses and gathered parameters within 1e-5, and its checkpoint
(split parameters and momentum gathered whole) resumes in one process."""

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
from tpufw.models import ResNet as JResNet
from tpufw.models import ResNetConfig as JResNetConfig
from tpufw.models import ViT as JViT
from tpufw.models import ViTConfig as JViTConfig
from tpufw.train import VisionTrainer as JVisionTrainer
from tpufw.train import VisionTrainerConfig as JVisionTrainerConfig
from tpufw_torch.interop import vision_params_from_flax
from tpufw_torch.mesh import MeshConfig
from tpufw_torch.models import ResNetConfig, ViTConfig
from tpufw_torch.parallel.tensor import split_specs
from tpufw_torch.train import VisionTrainer, VisionTrainerConfig
from tpufw_torch.train import synthetic_images

VIT = dict(image_size=32, patch_size=8, num_classes=10, d_model=64,
           n_layers=2, n_heads=4, d_ff=128)
RESNET = dict(num_classes=10, stage_sizes=(1, 1), width=8)
MODELS = {"vit": (JViT, JViTConfig(**VIT, dtype=jnp.float32),
                  ViTConfig(**VIT, dtype=torch.float32)),
          "resnet": (JResNet, JResNetConfig(**RESNET, dtype=jnp.float32),
                     ResNetConfig(**RESNET, dtype=torch.float32))}
KW = dict(batch_size=8, image_size=32, num_classes=10, total_steps=3,
          lr=0.05, warmup_steps=1)
TP2 = {"tensor": 2, "fsdp": 1}
TOL = dict(rtol=2e-4, atol=2e-4)


def _batches():
    it = synthetic_images(8, 32, 10)
    return [dict(next(it)) for _ in range(3)]


def _port(name, state, mesh=None):
    """(losses, final state dict, the trainer) of the port's one-process
    run over ``mesh`` (a MeshConfig's kwargs; None: unsplit)."""
    tr = VisionTrainer(MODELS[name][2], VisionTrainerConfig(
        **KW, handle_preemption=False),
        None if mesh is None else MeshConfig(**mesh), device="cpu")
    tr.init_state(state_dict=state)
    history = tr.run(iter(_batches()), flops_per_image=1.0)
    return ([m.loss for m in history],
            {k: v.detach() for k, v in tr.model.state_dict().items()}, tr)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("tensor_vision")
    jts, states, paths = {}, {}, {}
    for name, (jcls, jc, tc) in MODELS.items():
        jt = JVisionTrainer(jcls(jc), JVisionTrainerConfig(**KW),
                            JMeshConfig(data=2, fsdp=2, tensor=2))
        jt.init_state(seed=0)
        v = jax.device_get({"params": jt.state.params,
                            "batch_stats": jt.state.batch_stats})
        states[name] = vision_params_from_flax(v["params"], tc,
                                               v["batch_stats"] or None)
        jts[name] = jt
        paths[name] = write_case(
            tmp / f"{name}.pt", name, tc, {}, TP2, states[name], _batches(),
            kind="vision", vision_trainer=dict(
                KW, handle_preemption=False, checkpoint_every=3,
                checkpoint_dir=str(tmp / f"{name}_ckpt")))
    procs = start_gang([WORKER, *paths.values()])
    try:
        want = {}
        for name, jt in jts.items():
            hist = jt.run(iter(_batches()), flops_per_image=1.0)
            want[name] = ([m.loss for m in hist], vision_params_from_flax(
                jax.device_get(jt.state.params), MODELS[name][2],
                jax.device_get(jt.state.batch_stats) or None))
        split = {name: _port(name, states[name], TP2) for name in MODELS}
        whole = {name: _port(name, states[name]) for name in MODELS}
    finally:
        finish(procs)
    return ({name: read_outputs(p) for name, p in paths.items()}, want,
            split, whole, tmp)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_vision_trainer_matches_tpufw(runs, name):
    _, want, split, _, _ = runs
    losses, state, tr = split[name]
    assert [g.size for g in tr.groups] == [2, 1]
    assert len(losses) == KW["total_steps"]
    np.testing.assert_allclose(losses, want[name][0], rtol=1e-4)
    assert state.keys() == want[name][1].keys()
    for k, v in want[name][1].items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_parameters_follow_tpufw_axes(runs, name):
    """The split parameters: ViT's attention and MLP on their heads and
    width, k and v with q (tpufw keeps them whole); the class head's
    rows in both families; nothing of ResNet's trunk."""
    model = runs[2][name][2].model
    specs = split_specs(model)
    assert specs["head.weight"] == (("tensor", 0),)
    assert specs["head.bias"] == (("tensor", 0),)
    if name == "resnet":
        assert set(specs) == {"head.weight", "head.bias"}
        return
    blk = "blocks.0."
    want = {"q": 0, "k": 0, "v": 0, "up": 0, "o": 1, "down": 1}
    for proj, dim in want.items():
        assert specs[f"{blk}{proj}.weight"] == (("tensor", dim),), proj
    assert f"{blk}o.bias" not in specs and f"{blk}down.bias" not in specs
    assert not any(k.startswith(("patch_embed", "pos_embed", "cls_token"))
                   or "norm" in k for k in specs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tensor_gang_equals_one_process(runs, name):
    got, _, _, whole, _ = runs
    losses, state, _ = whole[name]
    assert got[name][0]["losses"] == got[name][1]["losses"]
    np.testing.assert_allclose(got[name][0]["losses"], losses, rtol=1e-5)
    params = got[name][0]["params"]
    assert params.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tensor_gang_checkpoint_resumes_in_one_process(runs, name):
    """The gang saved step 3 whole (the split parameters and their
    momentum gathered over the tensor ranks): one process restores the
    unsplit run's parameters and momentum."""
    _, _, _, whole, tmp = runs
    _, state, one = whole[name]
    tr = VisionTrainer(MODELS[name][2], VisionTrainerConfig(
        **KW, checkpoint_dir=str(tmp / f"{name}_ckpt"),
        handle_preemption=False), device="cpu")
    assert tr.maybe_restore() and tr.step == KW["total_steps"]
    for k, v in state.items():
        np.testing.assert_allclose(tr.model.state_dict()[k].numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    got = tr.optimizer.state_dict()["sgd"]["state"]
    want = one.optimizer.state_dict()["sgd"]["state"]
    assert got.keys() == want.keys() and want
    for i, st in want.items():
        np.testing.assert_allclose(got[i]["momentum_buffer"].numpy(),
                                   st["momentum_buffer"].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=str(i))
