"""The port's ``VisionTrainer`` as a 2-process gloo gang over its default
mesh (every rank on ``fsdp``) against ``tpufw``'s ``VisionTrainer`` on
``MeshConfig(data=2, fsdp=4)`` (its virtual devices) and against the
port's one-process trainer, from the same Flax weights, tiny ViT and
ResNet, 3 steps on the global batches of ``synthetic_images``: each rank
feeds its half of every batch (``batch_rows``).

Held: the losses within rtol 1e-4 of ``tpufw``'s and the gathered
parameters and BatchNorm running statistics within 2e-4; against one
process the same within 1e-5. A ResNet case whose halves have different
means holds synchronized BatchNorm: per-rank statistics would move its
losses far outside 1e-5 (shown beside it). A rank's SIGTERM after step 1
stops both ranks there with one gathered checkpoint (BN statistics and
momentum included), which resumes in one process as the unbroken run.
The gang (``tests/torch_gang_worker.py``) imports no JAX; this process
computes the references while it runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from tpufw_torch.models import ResNet, ResNetConfig, ViTConfig
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
STATS = ("running_mean", "running_var")


def _batches(shift=0.0):
    """3 global batches; ``shift``: the first half's images moved up by
    it and the second's down, so each half's channel means differ."""
    it = synthetic_images(8, 32, 10)
    out = [dict(next(it)) for _ in range(3)]
    for b in out:
        b["images"] = b["images"] + np.where(
            np.arange(8) < 4, shift, -shift)[:, None, None, None].astype(
                np.float32)
    return out


def _one_process(name, state, batches, **kw):
    tr = VisionTrainer(MODELS[name][2], VisionTrainerConfig(
        **{**KW, **kw}, handle_preemption=False), device="cpu")
    tr.init_state(state_dict=state)
    history = tr.run(iter(batches), flops_per_image=1.0)
    return [m.loss for m in history], tr.model.state_dict()


# name: (model, image shift, stop: a rank's SIGTERM after step 1).
CASES = {"vit": ("vit", 0.0, False), "resnet": ("resnet", 0.0, False),
         "resnet_shifted": ("resnet", 1.5, False),
         "resnet_stop": ("resnet", 0.0, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang_vision")
    jts, states, paths = {}, {}, {}
    for name, (jcls, jc, tc) in MODELS.items():
        jt = JVisionTrainer(jcls(jc), JVisionTrainerConfig(**KW),
                            JMeshConfig(data=2, fsdp=4))
        jt.init_state(seed=0)
        v = jax.device_get({"params": jt.state.params,
                            "batch_stats": jt.state.batch_stats})
        states[name] = vision_params_from_flax(v["params"], tc,
                                               v["batch_stats"] or None)
        jts[name] = jt
    ckpt = str(tmp / "ckpt")
    for name, (model, shift, stop) in CASES.items():
        extra = dict(signal_rank=1, signal_at=1) if stop else {}
        paths[name] = write_case(
            tmp / f"{name}.pt", name, MODELS[model][2],
            {}, {}, states[model], _batches(shift), kind="vision",
            vision_trainer=dict(KW, **({"checkpoint_dir": ckpt,
                                        "checkpoint_every": 1000}
                                       if stop else
                                       {"handle_preemption": False})),
            **extra)
    procs = start_gang([WORKER, *paths.values()])
    try:
        want = {}
        for name, jt in jts.items():
            hist = jt.run(iter(_batches()), flops_per_image=1.0)
            want[name] = ([m.loss for m in hist], vision_params_from_flax(
                jax.device_get(jt.state.params), MODELS[name][2],
                jax.device_get(jt.state.batch_stats) or None))
        one = {name: _one_process(model, states[model], _batches(shift))
               for name, (model, shift, _) in CASES.items() if name in
               ("vit", "resnet", "resnet_shifted")}
    finally:
        finish(procs)
    got = {name: read_outputs(p) for name, p in paths.items()}
    resumed = VisionTrainer(MODELS["resnet"][2], VisionTrainerConfig(
        **KW, checkpoint_dir=ckpt, handle_preemption=False), device="cpu")
    assert resumed.maybe_restore() and resumed.step == 1
    history = resumed.run(iter(_batches()[1:]), flops_per_image=1.0)
    again = ([m.loss for m in history], resumed.model.state_dict())
    return got, want, one, states, again


@pytest.mark.parametrize("name", ["vit", "resnet"])
def test_gang_matches_tpufw_global_batch(runs, name):
    got, want, _, _, _ = runs
    losses, params = want[name]
    for rank in got[name]:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-4)
    gathered = got[name][0]["params"]
    assert gathered.keys() == params.keys()
    assert (name == "resnet") == any(k.endswith(STATS) for k in params)
    for k, v in params.items():
        np.testing.assert_allclose(gathered[k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", ["vit", "resnet", "resnet_shifted"])
def test_gang_matches_one_process(runs, name):
    got, _, one, _, _ = runs
    losses, params = one[name]
    assert got[name][0]["losses"] == got[name][1]["losses"]
    np.testing.assert_allclose(got[name][0]["losses"], losses, rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got[name][0]["params"][k].numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_shifted_halves_need_global_statistics(runs):
    """The shifted case's first loss with each half normalized by its own
    statistics (what ranks with local BatchNorm would compute) is far
    from the global batch's, which the gang matched within 1e-5."""
    got, _, _, states, _ = runs
    model = ResNet(MODELS["resnet"][2], device="cpu").train()
    model.load_state_dict(states["resnet"])
    b = _batches(1.5)[0]
    images, labels = torch.as_tensor(b["images"]), torch.as_tensor(
        b["labels"])
    with torch.no_grad():
        local = np.mean([float(F.cross_entropy(
            model(images[h]), labels[h])) for h in (slice(0, 4),
                                                    slice(4, 8))])
    gang = got["resnet_shifted"][0]["losses"][0]
    assert abs(local - gang) > 1e-2 * abs(gang)


def test_gang_stop_resumes_in_one_process(runs):
    """Rank 1's SIGTERM after step 1 stops both ranks at step 1 with one
    forced, gathered checkpoint; one process resumes it and trains steps
    2-3 as the unbroken gang's one-process twin: parameters, BatchNorm
    statistics and momentum crossed."""
    got, _, one, _, again = runs
    assert [(r["preempted"], r["step"]) for r in got["resnet_stop"]] == \
        [(True, 1), (True, 1)]
    losses, params = one["resnet"]
    np.testing.assert_allclose(got["resnet_stop"][0]["losses"], losses[:1],
                               rtol=1e-5)
    np.testing.assert_allclose(again[0], losses[1:], rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(again[1][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
