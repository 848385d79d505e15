"""tpufw_torch ViT and ResNet vs tpufw: logits in train and eval mode,
BatchNorm statistics, SAME padding, the bf16 BatchNorm, VisionTrainer
steps, checkpoint resume and SIGTERM, parameter counts and the two
workloads. CPU, fp32, tiny models (ViT 32 px, patch 8, d 64, 2 layers;
ResNet stages (1, 1) at width 8); weights cross from the Flax trees
through ``vision_params_from_flax``.

Tolerances: logits and statistics 2e-4 (``tests/conftest.py``'s tree
tolerance); 3-step trainer losses rtol 1e-4, as ``test_torch_trainer.py``'s
trajectory test.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.core import meta

from tpufw.mesh import MeshConfig
from tpufw.models import VIT_CONFIGS as J_VIT_CONFIGS
from tpufw.models import ResNet as JResNet
from tpufw.models import ResNetConfig as JResNetConfig
from tpufw.models import ViT as JViT
from tpufw.models import ViTConfig as JViTConfig
from tpufw.train import VisionTrainer as JVisionTrainer
from tpufw.train import VisionTrainerConfig as JVisionTrainerConfig
from tpufw.train import synthetic_images as j_synthetic_images
from tpufw_torch.interop import vision_params_from_flax
from tpufw_torch.models import VIT_CONFIGS, ResNet, ResNetConfig, ViT, ViTConfig
from tpufw_torch.models.resnet import Conv, same_padding
from tpufw_torch.train import VisionTrainer, VisionTrainerConfig
from tpufw_torch.train import synthetic_images
from tpufw_torch.train.preemption import GracefulShutdown

TOL = dict(rtol=2e-4, atol=2e-4)
VIT = dict(image_size=32, patch_size=8, num_classes=10, d_model=64,
           n_layers=2, n_heads=4, d_ff=128)
RESNET = dict(num_classes=10, stage_sizes=(1, 1), width=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models run one intra-op thread: many threads of several test
    workers on one host's cores spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vit(pool="cls", scan=True, **kw):
    return (JViTConfig(**VIT, pool=pool, dtype=jnp.float32, scan_layers=scan,
                       **kw),
            ViTConfig(**VIT, pool=pool, dtype=torch.float32, **kw))


def _resnet(norm=("float32", "float32")):
    return (JResNetConfig(**RESNET, dtype=jnp.float32,
                          norm_dtype=getattr(jnp, norm[0])),
            ResNetConfig(**RESNET, dtype=torch.float32,
                         norm_dtype=getattr(torch, norm[1])))


def _images(n=4, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _flax(jmodel, seed=1, tweak_heads=True):
    """Host Flax variables; the zero-initialised heads (ViT's) get seeded
    values so the logits are not all zero."""
    v = jax.device_get(meta.unbox(jax.jit(
        lambda k, x: jmodel.init(k, x, train=True))(
            jax.random.key(seed), jnp.asarray(_images()))))
    v = dict(v)
    if tweak_heads:
        head = v["params"]["head"]
        rng = np.random.default_rng(seed)
        v["params"] = {**v["params"], "head": {
            k: rng.standard_normal(x.shape).astype(np.float32)
            for k, x in head.items()}}
    return v


def _port(model_cls, cfg, v):
    m = model_cls(cfg, device="cpu")
    m.load_state_dict(vision_params_from_flax(v["params"], cfg,
                                              v.get("batch_stats")))
    return m


@pytest.mark.parametrize("pool, scan", [("cls", True), ("cls", False),
                                        ("mean", True)])
@pytest.mark.parametrize("train", [False, True])
def test_vit_logits_match_tpufw(pool, scan, train):
    jc, tc = _vit(pool, scan, remat=train)
    v = _flax(JViT(jc))
    imgs = _images()
    want = np.asarray(jax.jit(lambda v, x: JViT(jc).apply(v, x, train=train))(
        v, jnp.asarray(imgs)))
    model = _port(ViT, tc, v).train(train)
    got = model(torch.as_tensor(imgs))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert got.dtype == torch.float32 and got.shape == (4, 10)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_logits_and_batch_stats_match_tpufw(train):
    """Eval mode normalizes with the running statistics, train mode with
    the batch's and updates the running ones as flax does (momentum 0.9,
    the biased batch variance), to 2e-4."""
    jc, tc = _resnet()
    v = _flax(JResNet(jc))
    imgs = _images()
    model = _port(ResNet, tc, v).train(train)
    with torch.no_grad():
        got = model(torch.as_tensor(imgs)).numpy()
    if not train:
        want = jax.jit(lambda v, x: JResNet(jc).apply(v, x, train=False))(
            v, jnp.asarray(imgs))
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        return
    want, mutated = jax.jit(lambda v, x: JResNet(jc).apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(imgs))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    stats = vision_params_from_flax(v["params"], tc,
                                    jax.device_get(mutated["batch_stats"]))
    sd = model.state_dict()
    running = [k for k in stats if k.endswith(("running_mean",
                                               "running_var"))]
    assert len(running) == 2 * 9  # bn_init and 4 a block (bn_proj too)
    for k in running:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(),
                                   err_msg=k, **TOL)
    before = vision_params_from_flax(v["params"], tc, v["batch_stats"])
    assert all(not torch.equal(sd[k], before[k]) for k in running)


def test_same_padding_of_stride2_conv_on_even_input():
    """flax's SAME pads a stride-2 3x3 conv on an even input (0, 1): the
    port's Conv equals lax.conv_general_dilated with "SAME"; torch's
    symmetric padding=1 gives another result (it shifts every window up
    and left by one pixel)."""
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(33, 3, 2) == (1, 1)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    x = _images(2, 32, seed=3)
    k = np.random.default_rng(4).standard_normal((3, 3, 3, 5)).astype(
        np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    conv = Conv(3, 5, 3, 2, _resnet()[1], None, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(k).permute(3, 2, 0, 1))
        xt = torch.as_tensor(x).permute(0, 3, 1, 2)
        got = conv(xt).permute(0, 2, 3, 1).numpy()
        symmetric = F.conv2d(xt, conv.weight, stride=2, padding=1).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(symmetric - want).max() > 0.1


def test_bf16_batchnorm_matches_f32():
    """norm_dtype bf16 (the workload's default) is the f32 model at bf16
    tolerance, as tests/test_resnet.py holds tpufw's (rtol 0.1, atol
    0.15; statistics 2e-2): statistics are reduced in fp32 either way.
    The port's bf16 model also equals tpufw's bf16 model."""
    jc32, tc32 = _resnet()
    jc16, tc16 = _resnet(("bfloat16", "bfloat16"))
    v = _flax(JResNet(jc32), tweak_heads=False)
    imgs = torch.as_tensor(_images(4, 32, seed=5))
    out = {}
    for name, tc in (("f32", tc32), ("bf16", tc16)):
        m = _port(ResNet, tc, v).train()
        with torch.no_grad():
            out[name] = (m(imgs).numpy(), m.state_dict())
    np.testing.assert_allclose(out["bf16"][0], out["f32"][0], rtol=0.1,
                               atol=0.15)
    for k, t in out["f32"][1].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(out["bf16"][1][k].numpy(), t.numpy(),
                                       rtol=2e-2, atol=2e-2, err_msg=k)
    want = jax.jit(lambda v, x: JResNet(jc16).apply(
        v, x, train=True, mutable=["batch_stats"])[0])(
            v, jnp.asarray(imgs.numpy()))
    np.testing.assert_allclose(out["bf16"][0], np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("name", ["vit", "resnet"])
def test_vision_trainer_losses_match_tpufw(devices8, name):
    """Three VisionTrainer steps from tpufw's init on the same synthetic
    images: the port's losses equal tpufw's (rtol 1e-4): masked weight
    decay, nesterov SGD, the warmup-cosine rate at the pre-increment
    count, BatchNorm in train mode."""
    jc, tc = _vit() if name == "vit" else _resnet()
    jmodel = JViT(jc) if name == "vit" else JResNet(jc)
    kw = dict(batch_size=8, image_size=32, num_classes=10, total_steps=3,
              lr=0.05, warmup_steps=1)
    jt = JVisionTrainer(jmodel, JVisionTrainerConfig(**kw),
                        MeshConfig(data=8))
    jt.init_state(seed=0)
    v = jax.device_get({"params": jt.state.params,
                        "batch_stats": jt.state.batch_stats})
    j_hist = jt.run(j_synthetic_images(8, 32, 10), flops_per_image=1e6)
    tt = VisionTrainer(tc, VisionTrainerConfig(**kw), device="cpu")
    tt.init_state(state_dict=vision_params_from_flax(
        v["params"], tc, v["batch_stats"] or None))
    t_hist = tt.run(synthetic_images(8, 32, 10), flops_per_image=1e6)
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose([m.loss for m in t_hist],
                               [m.loss for m in j_hist], rtol=1e-4)
    want = vision_params_from_flax(
        jax.device_get(jt.state.params), tc,
        jax.device_get(jt.state.batch_stats) or None)
    got = tt.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def test_synthetic_images_byte_identical():
    for a, b in zip(j_synthetic_images(3, 16, 7, seed=5, pool=2),
                    synthetic_images(3, 16, 7, seed=5, pool=2)):
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        break


def test_param_counts_match_tpufw():
    """vit_b16 (86.6 M) against tpufw's ViTConfig.n_params formula, and
    resnet50 (25.56 M) against tpufw's abstract init (jax.eval_shape: no
    weights drawn); the port's models built on ``meta``."""
    from tpufw.models import resnet50 as j_resnet50
    from tpufw_torch.models import resnet50

    n = sum(p.numel() for p in ViT(VIT_CONFIGS["vit_b16"],
                                   device="meta").parameters())
    assert n == J_VIT_CONFIGS["vit_b16"].n_params() == \
        VIT_CONFIGS["vit_b16"].n_params() == 86_567_656
    shapes = jax.eval_shape(j_resnet50().init, jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in resnet50(device="meta").parameters()) \
        == want
    assert VIT_CONFIGS["vit_b16"].flops_per_image() == \
        J_VIT_CONFIGS["vit_b16"].flops_per_image()
    assert ResNetConfig().flops_per_image(160) == \
        JResNetConfig().flops_per_image(160)


def test_config_validation():
    with pytest.raises(ValueError):
        ViTConfig(image_size=224, patch_size=15)
    with pytest.raises(ValueError):
        ViTConfig(pool="max")
    with pytest.raises(ValueError):
        ViTConfig(d_model=100, n_heads=7)


def _trainer(tmp_path, total, **kw):
    cfg = VisionTrainerConfig(batch_size=4, image_size=32, num_classes=10,
                              total_steps=total, lr=0.05, warmup_steps=1,
                              checkpoint_dir=str(tmp_path / "ck"), **kw)
    return VisionTrainer(_resnet()[1], cfg, device="cpu")


def _data(skip=0):
    it = synthetic_images(4, 32, 10, seed=2)
    for _ in range(skip):
        next(it)
    return it


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """4 steps straight equal 2 steps, a checkpoint and a fresh trainer's
    steps 3-4 bit for bit: parameters, BN statistics and momentum."""
    straight = VisionTrainer(_resnet()[1], VisionTrainerConfig(
        batch_size=4, image_size=32, num_classes=10, total_steps=4, lr=0.05,
        warmup_steps=1), device="cpu")
    straight.init_state(seed=0)
    h0 = straight.run(_data(), flops_per_image=1.0)
    first = _trainer(tmp_path, 2, checkpoint_every=2)
    first.init_state(seed=0)
    first.run(_data(), flops_per_image=1.0)
    resumed = _trainer(tmp_path, 4, checkpoint_every=2)
    assert resumed.maybe_restore() and resumed.step == 2
    h1 = resumed.run(_data(skip=2), flops_per_image=1.0)
    assert [m.loss for m in h1] == [m.loss for m in h0[2:]]
    want = straight.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert resumed.optimizer.count == straight.optimizer.count == 4


def test_sigterm_stop_and_resume(tmp_path):
    """A stop request ends the run with a forced checkpoint at the stop
    step; a fresh trainer resumes there and trains what is left."""
    trainer = _trainer(tmp_path, 32, checkpoint_every=1000)
    trainer.init_state(seed=0)
    sd = GracefulShutdown(signals=())

    def hook(m):
        if m.step >= 2:
            sd.request()

    hist = trainer.run(_data(), flops_per_image=1.0, on_metrics=hook,
                       shutdown=sd)
    assert trainer.preempted and 2 <= trainer.step < 32
    assert len(hist) == trainer.step
    resumed = _trainer(tmp_path, trainer.step + 2, checkpoint_every=1000)
    assert resumed.maybe_restore() and resumed.step == trainer.step
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert len(resumed.run(_data(), flops_per_image=1.0)) == 2


@pytest.mark.parametrize("workload, env", [
    ("train_vit", dict(MODEL="vit_test", BATCH_SIZE=2, TOTAL_STEPS=2,
                       NUM_CLASSES=10, LR_MILLI=5, SYNC_EVERY=1)),
    ("train_resnet", dict(BATCH_SIZE=2, TOTAL_STEPS=2, IMAGE_SIZE=32,
                          NUM_CLASSES=10, NORM_DTYPE="float32")),
])
def test_workloads_on_cpu(monkeypatch, capsys, tmp_path, workload, env):
    """Each workload under TPUFW_DEVICE=cpu prints one JSON line a step and
    the TRAIN OK line; rerun with more steps it resumes from its
    checkpoint. Both run tiny models: the ViT workload a 32 px preset put
    beside the real ones (its presets are all 224 px, and it has no size
    knob), the ResNet workload the test's two-stage ResNet (it builds
    ResNet-50 and has no depth knob)."""
    import importlib

    import tpufw_torch.models

    mod = importlib.import_module(f"tpufw_torch.workloads.{workload}")
    vit_test = dataclasses.replace(_vit()[1], remat=True)
    monkeypatch.setitem(VIT_CONFIGS, "vit_test", vit_test)
    monkeypatch.setattr(tpufw_torch.models, "ResNetConfig", functools.partial(
        ResNetConfig, stage_sizes=(1, 1), width=8, dtype=torch.float32))
    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    env = {**env, "DEVICE": "cpu", "CHECKPOINT_DIR": str(tmp_path),
           "CHECKPOINT_EVERY": 2, "HANDLE_PREEMPTION": 0}
    for k, v in env.items():
        monkeypatch.setenv(f"TPUFW_{k}", str(v))
    trainer, mcfg = mod.build_trainer()
    if workload == "train_vit":
        assert trainer.cfg.lr == 0.005 and mcfg.remat
        assert mcfg == vit_test and trainer.cfg.image_size == 32
    else:
        assert mcfg.norm_dtype == torch.float32 and trainer.cfg.lr == 0.1
    assert mod.main() == 0
    out = capsys.readouterr().out.splitlines()
    steps = [json.loads(ln) for ln in out if ln.startswith('{"step"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)
    assert out[-1].startswith("TRAIN OK: 2 ")
    monkeypatch.setenv("TPUFW_TOTAL_STEPS", "3")
    assert mod.main() == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out
    assert [json.loads(ln)["step"] for ln in out.splitlines()
            if ln.startswith('{"step"')] == [3]
