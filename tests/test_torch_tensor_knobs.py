"""Tensor parallelism in one process under the trainer's knobs: as
``test_torch_tensor.py`` holds Llama, ``grad_accum=2`` (strided
microbatches of a global batch of 16) and packed segments (the loss mask
of document boundaries and padding, the chunked vocab-parallel loss).

The set-up: the port's ``Trainer`` over a
``LocalTensorGroup(2)`` (every Megatron shard computed in turn from the
whole weights: column-parallel q/k/v and gate/up, row-parallel o and
down, the vocab-parallel embedding, head and cross-entropy) against
``tpufw``'s ``Trainer`` on ``MeshConfig(data=2, fsdp=2, tensor=2)`` over
its 8 virtual devices (``tests/test_train.py``'s mesh), from the same
Flax weights, in fp32, for 3 steps: losses within rtol 1e-4, grad norms
and the final parameters within 2e-4 (``tests/conftest.py``'s
tolerance)."""

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
    "llama_grad_accum": ("llama3_tiny", {"grad_accum": 2}, False, 16),
    "llama_packed": ("llama3_tiny", {"loss_chunk_size": 8,
                                     "loss_chunk_dtype": "float32"},
                     True, BATCH),
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
