"""Expert parallelism in one process for DeepSeek's MoE (fine-grained
routed experts with V2's raw softmax gates, and shared experts): the
port's ``Trainer`` on ``LocalExpertGroup(2)`` against ``tpufw``'s on
``MeshConfig(fsdp=-1, expert=2)`` (``tests/test_deepseek.py``'s mesh),
as ``test_torch_expert.py`` holds Mixtral, and on ``LocalExpertGroup(2)``
x ``LocalTensorGroup(2)`` (the shared experts' MLP and the MLA heads
split too) against every parameter's unsplit gradient. Losses rtol 1e-4,
grad norms and parameters 2e-4; gradients 1e-5."""

import pytest

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
from tpufw.models import DEEPSEEK_CONFIGS as J_CONFIGS
from tpufw_torch.models import DEEPSEEK_CONFIGS


@pytest.fixture(scope="module")
def run(devices8):
    jcfg, tcfg = fp32_pair(J_CONFIGS, DEEPSEEK_CONFIGS, "deepseek_moe_tiny")
    data = batches(tcfg)
    want = jax_run(jcfg, tcfg, dict(fsdp=-1, expert=2), data)
    got = port_run(tcfg, want[0], data, local_groups(2, 1))
    return got, want, tcfg, data


def test_local_expert_group_matches_tpufw_expert_mesh(run):
    got, want, _, _ = run
    assert_matches(got, want)


@pytest.mark.parametrize("ep,tp", [(2, 1), (2, 2), (4, 2)])
def test_every_gradient_equals_the_unsplit_models(run, ep, tp):
    _, want, tcfg, data = run
    grads = assert_grads_unsplit(tcfg, want[0], data[0],
                                 local_groups(ep, tp))
    assert any("router" in k for k in grads)
    assert any("shared" in k for k in grads)
