"""Expert parallelism in one process: a MoE layer's experts split over a
``LocalExpertGroup`` (each shard running its experts' capacity slots of
the global routing) and their widths over a ``LocalTensorGroup``, in the
port's ``Trainer``, against ``tpufw``'s ``Trainer`` on its meshes:

- Mixtral tiny on ``LocalExpertGroup(4)`` x ``LocalTensorGroup(2)``
  against ``MeshConfig(fsdp=1, expert=4, tensor=2)``
  (``tests/test_mixtral.py``'s mesh), with the einsum dispatch; and the
  sorted dispatch split over ``tensor`` alone;
- DeepSeek's MoE tiny in ``test_torch_expert_deepseek.py``.

Losses rtol 1e-4 (the router's aux and z losses are in them), grad norms
and parameters 2e-4. Every parameter's gradient, the router's included,
equals the unsplit model's (Adam's update is blind to a gradient's
scale, so the final parameters alone would not show a router gradient
counted twice)."""

import dataclasses

import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import (
    assert_grads_unsplit,
    assert_matches,
    batches,
    fp32_pair,
    jax_run,
    local_groups,
    port_run,
)
from tpufw.models import MIXTRAL_CONFIGS as J_CONFIGS
from tpufw_torch.models import MIXTRAL_CONFIGS
from tpufw_torch.parallel import use_groups

# name: (config overrides, tpufw's mesh, the port's (expert, tensor)).
CASES = {
    "mixtral_ep4_tp2": ({}, dict(fsdp=1, expert=4, tensor=2), (4, 2)),
    "mixtral_sorted_tp2": ({"moe_dispatch": "sorted"},
                           dict(data=2, fsdp=2, tensor=2), (1, 2)),
}


@pytest.fixture(scope="module")
def runs(devices8):
    out = {}
    for name, (over, mesh, (ep, tp)) in CASES.items():
        jcfg, tcfg = fp32_pair(J_CONFIGS, MIXTRAL_CONFIGS, "mixtral_tiny",
                               **over)
        data = batches(tcfg)
        want = jax_run(jcfg, tcfg, mesh, data)
        got = port_run(tcfg, want[0], data, local_groups(ep, tp))
        out[name] = got, want, tcfg, data
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_expert_groups_match_tpufw_expert_mesh(runs, name):
    got, want, _, _ = runs[name]
    assert_matches(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_gradient_equals_the_unsplit_models(runs, name):
    _, want, tcfg, data = runs[name]
    grads = assert_grads_unsplit(tcfg, want[0], data[0],
                                 local_groups(*CASES[name][2]))
    assert any("router" in k for k in grads)


def test_aux_and_z_losses_are_the_unsplit_ones():
    """The layers' router losses under the groups are the unsplit
    model's, and their gradient reaches the router once."""
    from tpufw_torch.models import model_for_config

    cfg = dataclasses.replace(MIXTRAL_CONFIGS["mixtral_tiny"],
                              dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    out = []
    for groups in ((), local_groups(4, 2)):
        model = model_for_config(cfg, device="cpu", seed=1)
        with use_groups(**{g.axis: g for g in groups}):
            _, aux = model(tokens, return_aux=True, return_hidden=True)
            aux.backward()
        out.append((aux.detach(), model.layers[0].moe.router.weight.grad))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-5, atol=1e-7)
