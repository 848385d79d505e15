"""Tensor parallelism in one process: the port's ``Trainer`` over a
``LocalTensorGroup(2)`` (every Megatron shard computed in turn from the
whole weights: column-parallel q/k/v and gate/up, row-parallel o and
down, the vocab-parallel embedding, head and cross-entropy) against
``tpufw``'s ``Trainer`` on ``MeshConfig(data=2, fsdp=2, tensor=2)`` over
its 8 virtual devices (``tests/test_train.py``'s mesh), from the same
Flax weights, in fp32, for 3 steps: losses within rtol 1e-4, grad norms
and the final parameters within 2e-4 (``tests/conftest.py``'s
tolerance). Llama, Qwen (QKV bias, the chunked vocab-parallel loss) and
Mistral (window); ``grad_accum`` and packed segments are in
``test_torch_tensor_knobs.py``, Gemma-2 in ``test_torch_tensor_gemma.py``
and DeepSeek's MLA in ``test_torch_tensor_mla.py``."""

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import (
    BATCH,
    TP_MESH,
    assert_matches,
    batches,
    fp32_pair,
    jax_run,
    port_run,
)
from tpufw_torch.parallel import LocalTensorGroup

# name: (preset, trainer knobs, packed, global batch).
CASES = {
    "llama3_tiny": ("llama3_tiny", {}, False, BATCH),
    "qwen25_tiny": ("qwen25_tiny", {"loss_chunk_size": 8,
                                    "loss_chunk_dtype": "float32"},
                    False, BATCH),
    "mistral_tiny": ("mistral_tiny", {}, False, BATCH),
}


@pytest.fixture(scope="module")
def runs(devices8):
    from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
    from tpufw_torch.models import LLAMA_CONFIGS

    out = {}
    for name, (preset, kw, packed, batch) in CASES.items():
        jcfg, tcfg = fp32_pair(J_CONFIGS, LLAMA_CONFIGS, preset)
        data = batches(tcfg, packed, batch)
        want = jax_run(jcfg, tcfg, TP_MESH, data, **kw)
        got = port_run(tcfg, want[0], data, (LocalTensorGroup(2),), **kw)
        out[name] = got, want
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_tensor_group_matches_tpufw_tensor_mesh(runs, name):
    assert_matches(*runs[name])
