"""Tensor parallelism in one process for DeepSeek's MLA: the port's
``Trainer`` over a ``LocalTensorGroup(2)`` against ``tpufw``'s on
``MeshConfig(data=2, fsdp=2, tensor=2)``, as ``test_torch_tensor.py``
holds Llama: the query (full-rank, or low-rank's up-projection) and
``kv_b_kernel`` split on the heads, the latent down-projections and
their norms replicated, o row-parallel, the dense MLP split. Losses rtol
1e-4, grad norms and parameters 2e-4."""

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import (
    TP_MESH,
    assert_matches,
    batches,
    fp32_pair,
    jax_run,
    port_run,
)
from tpufw.models import DEEPSEEK_CONFIGS as J_CONFIGS
from tpufw_torch.models import DEEPSEEK_CONFIGS as T_CONFIGS
from tpufw_torch.parallel import LocalTensorGroup

CHUNK = {"loss_chunk_size": 8, "loss_chunk_dtype": "float32"}
# name: (preset, trainer knobs).
CASES = {
    "deepseek_tiny": ("deepseek_tiny", {}),
    "deepseek_tiny_qlora": ("deepseek_tiny_qlora", CHUNK),
}


@pytest.fixture(scope="module")
def runs(devices8):
    out = {}
    for name, (preset, kw) in CASES.items():
        jcfg, tcfg = fp32_pair(J_CONFIGS, T_CONFIGS, preset)
        data = batches(tcfg)
        want = jax_run(jcfg, tcfg, TP_MESH, data, **kw)
        got = port_run(tcfg, want[0], data, (LocalTensorGroup(2),), **kw)
        out[name] = got, want
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_tensor_group_matches_tpufw_tensor_mesh(runs, name):
    assert_matches(*runs[name])
