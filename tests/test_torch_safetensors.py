"""tpufw_torch.io.safetensors against the installed ``safetensors`` and
``transformers``: the port reads what they write (all six dtypes, a
sharded index) and they read what the port writes, bit for bit."""

import json
import os

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.io import safetensors as st

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64}


def _tensors(seed=0):
    """One tensor per dtype, odd shapes, so that alignment matters."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, dt) in enumerate(DTYPES.items()):
        shape = (3, 5 + i) if i % 2 else (7 + i,)
        if dt.is_floating_point:
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        else:
            x = torch.from_numpy(rng.integers(-100, 100, shape))
        out[f"t_{name.lower()}"] = x.to(dt)
    out["scalar_f32"] = torch.tensor(1.5)
    out["empty_i8"] = torch.zeros((0, 4), dtype=torch.int8)
    return out


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_reads_the_packages_files(tmp_path):
    want = _tensors()
    path = tmp_path / "a.safetensors"
    torch_save_file(want, str(path), metadata={"format": "pt"})
    f = st.SafeFile(path)
    assert sorted(f.keys()) == sorted(want)
    assert f.metadata() == {"format": "pt"}
    for k, v in want.items():
        got = f.get(k)
        assert got.dtype == v.dtype and got.shape == v.shape
        assert torch.equal(_bits(got), _bits(v)), k
    # numpy writer (no bf16 in numpy): same values through the reader.
    arrays = {k: v.numpy() for k, v in want.items() if v.dtype != torch.bfloat16}
    np_save_file(arrays, str(tmp_path / "b.safetensors"))
    for k, v in st.load(tmp_path / "b.safetensors").items():
        np.testing.assert_array_equal(v.numpy(), arrays[k])


def test_packages_read_the_ports_files(tmp_path):
    want = _tensors(1)
    path = tmp_path / "p.safetensors"
    n = st.save_file(want, path, {"format": "pt"})
    assert n == sum(v.numel() * v.element_size() for v in want.values())
    with safe_open(str(path), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(want)
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == v.dtype and torch.equal(_bits(got), _bits(v))


def test_sharded_directory_both_ways(tmp_path):
    want = {f"layer.{i}.w": torch.full((256,), float(i)) for i in range(10)}
    files = st.save_sharded(want, tmp_path / "out", max_shard_bytes=2500)
    # 1 KiB a tensor, 2500 bytes a shard: two tensors per shard.
    assert files[:-1] == [f"model-0000{i}-of-00005.safetensors"
                          for i in range(1, 6)]
    index = json.loads((tmp_path / "out" / st.INDEX_NAME).read_text())
    assert index["metadata"]["total_size"] == 10 * 1024
    assert set(index["weight_map"]) == set(want)
    for k, fname in index["weight_map"].items():
        with safe_open(str(tmp_path / "out" / fname), framework="pt") as f:
            assert torch.equal(f.get_tensor(k), want[k])
    got = st.load(tmp_path / "out")
    assert all(torch.equal(got[k], want[k]) for k in want)
    # One shard when it fits: transformers' single-file name.
    assert st.save_sharded(want, tmp_path / "one") == ["model.safetensors"]


def test_reads_transformers_save_pretrained_shards(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    model = transformers.LlamaForCausalLM(cfg).to(torch.bfloat16)
    model.save_pretrained(tmp_path, max_shard_size="20KB",
                          safe_serialization=True)
    assert (tmp_path / st.INDEX_NAME).exists()
    got = st.load(tmp_path)
    want = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], v), k


def test_plan_matches_the_greedy_rule():
    sizes = [("a", 3), ("b", 3), ("c", 5), ("d", 1), ("e", 9)]
    assert st.plan_shards(sizes, 6) == [["a", "b"], ["c", "d"], ["e"]]


def test_rejects_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    st.save_file({"x": torch.arange(100, dtype=torch.int32)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="spans bytes"):
        st.SafeFile(path)
