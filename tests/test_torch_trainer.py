"""tpufw_torch training stack vs tpufw: data, optimizer, loss trajectory,
gradient accumulation, the workload entry point, device handling and
import hygiene. CPU, fp32."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import data as j_data
from tpufw.train.trainer import default_optimizer as j_default_optimizer
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import Trainer, TrainerConfig
from tpufw_torch.train import data as t_data
from tpufw_torch.train.trainer import LlamaAdamW, train_step, warmup_cosine_decay
from tpufw_torch.utils import hardware

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthetic_batches_byte_identical():
    for fn, kw in (("synthetic_batches", {}),
                   ("synthetic_packed_batches", {"mean_doc_len": 7})):
        a = list(getattr(j_data, fn)(3, 16, 50, seed=5, n_batches=3, **kw))
        b = list(getattr(t_data, fn)(3, 16, 50, seed=5, n_batches=3, **kw))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes()


def test_schedule_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 20, 3e-5)
    for step in range(25):
        np.testing.assert_allclose(
            warmup_cosine_decay(step, 3e-4, 5, 20, 3e-5), float(sched(step)),
            rtol=1e-5, atol=1e-12,
        )


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip off / on
def test_optimizer_matches_optax(grad_scale):
    """clip_by_global_norm + AdamW (decay on every param) + schedule,
    three updates, against tpufw's optax chain."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * grad_scale
              for s in shapes] for _ in range(3)]
    tx = j_default_optimizer(lr=1e-2, warmup_steps=1, total_steps=4)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = LlamaAdamW(tp, lr=1e-2, warmup_steps=1, total_steps=4)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        norm = opt.step()
        np.testing.assert_allclose(
            norm.item(), float(optax.global_norm(g)), rtol=1e-5
        )
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_three_step_trajectory_matches_flax_trainer(devices8):
    """Same init (Flax weights moved over), same synthetic batches, same
    optimizer: the loss of every step agrees to 1e-4 relative."""
    jcfg = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
    kw = dict(batch_size=8, seq_len=17, total_steps=3, lr=1e-2,
              warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32")
    jt = JTrainer(JLlama(jcfg), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(jt.state.params)
    j_hist = jt.run(t_data.synthetic_batches(8, 17, jcfg.vocab_size, seed=3),
                    model_flops_per_token=jcfg.flops_per_token(16))

    tt = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    tt.init_state(state_dict=params_from_flax(params, tcfg))
    t_hist = tt.run(t_data.synthetic_batches(8, 17, tcfg.vocab_size, seed=3),
                    model_flops_per_token=tcfg.flops_per_token(16))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose(
        [m.loss for m in t_hist], [m.loss for m in j_hist], rtol=1e-4
    )


@pytest.mark.parametrize("packed", [False, True])
def test_grad_accum_matches_one_shot(packed):
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
    gen = (t_data.synthetic_packed_batches(4, 33, cfg.vocab_size, seed=1,
                                           mean_doc_len=10)
           if packed else t_data.synthetic_batches(4, 33, cfg.vocab_size, seed=1))
    batch = {k: torch.from_numpy(v) for k, v in next(iter(gen)).items()}
    out = {}
    for accum in (1, 2):
        tr = Trainer(cfg, TrainerConfig(batch_size=4, seq_len=33,
                                        loss_chunk_size=16,
                                        loss_chunk_dtype="float32"),
                     device="cpu")
        model = tr.init_state(seed=0)
        m = train_step(model, tr.optimizer, batch, 16, "float32", accum)
        out[accum] = (m, {n: p.grad.clone() for n, p in model.named_parameters()})
    (m1, g1), (m2, g2) = out[1], out[2]
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=2e-4)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(),
                               rtol=2e-4)
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=n)


def test_workload_prints_one_json_line_per_step(monkeypatch, capsys):
    from tpufw_torch.workloads import train_llama

    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    for k, v in dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="2",
                     SEQ_LEN="17", TOTAL_STEPS="2", LOSS_CHUNK_SIZE="8",
                     ATTENTION="flash").items():
        monkeypatch.setenv(f"TPUFW_{k}", v)
    assert train_llama.main() == 0
    steps = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"step"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without device='cpu' the entry points want CUDA; on a machine
    without it they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLAMA_CONFIGS["llama3_tiny"]
    from tpufw_torch.models import Llama
    from tpufw_torch.workloads import train_llama

    monkeypatch.delenv("TPUFW_DEVICE", raising=False)
    for call in (lambda: Llama(cfg), lambda: Trainer(cfg, TrainerConfig()),
                 hardware.detect_chip, train_llama.build_trainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize(
    "name, spec",
    [("NVIDIA H100 80GB HBM3", "h100_sxm"), ("NVIDIA H100 PCIe", "h100_pcie"),
     ("Tesla V100-SXM2-16GB", None), ("NVIDIA A100-SXM4-80GB", None)],
)
def test_chip_from_name(name, spec):
    if spec is None:
        with pytest.raises(ValueError, match="unknown accelerator"):
            hardware.chip_from_name(name)
    else:
        assert hardware.chip_from_name(name).name == spec
    assert hardware.detect_chip("cpu").name == "cpu"


def test_port_imports_no_jax_and_no_tpufw():
    """Importing every tpufw_torch module (and chip_smoke.py) leaves no
    jax, flax, optax or tpufw module behind."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import tpufw_torch\n"
        "for m in pkgutil.walk_packages(tpufw_torch.__path__, 'tpufw_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpufw'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
