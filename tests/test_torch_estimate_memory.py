"""The port's memory estimate (``tpufw_torch.tools.estimate_memory``)
against ``tpufw``'s (``tests/test_estimate_memory.py`` case for case):
every component equal on the same presets and knobs, plus the CLI's JSON
keys and its static card table. Pure arithmetic, no backend."""

import dataclasses
import json
import subprocess
import sys

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.configs import bench_model_config as j_bench
from tpufw.models import DEEPSEEK_CONFIGS as J_DEEPSEEK
from tpufw.models import GEMMA_CONFIGS as J_GEMMA
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.models import MIXTRAL_CONFIGS as J_MIXTRAL
from tpufw.tools import estimate_memory as J
from tpufw_torch.configs import bench_model_config
from tpufw_torch.models import PRESETS
from tpufw_torch.tools import estimate_memory as T

J_PRESETS = {**J_LLAMA, **J_MIXTRAL, **J_GEMMA, **J_DEEPSEEK,
             "llama3_600m_bench": j_bench()}
CFG8B = PRESETS["llama3_8b"]


def _pair(name):
    tcfg = bench_model_config() if name == "llama3_600m_bench" \
        else PRESETS[name]
    return J_PRESETS[name], tcfg


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.total() == b.total() and a.as_dict() == b.as_dict()


# The presets and knobs of tpufw's tests, and each remat policy.
TRAIN_CASES = {
    "8b_fsdp1": ("llama3_8b", 16, 2048, dict(n_shards=1)),
    "8b_fsdp16": ("llama3_8b", 16, 2048, dict(n_shards=16)),
    "8b_chunk512": ("llama3_8b", 8, 2048, dict(loss_chunk_size=512)),
    "8b_accum2_mu_bf16": ("llama3_8b", 8, 2048,
                          dict(grad_accum=2, adam_mu_dtype="bfloat16")),
    "mixtral_fsdp8": ("mixtral_8x7b", 8, 2048,
                      dict(n_shards=8, remat_policy="dots")),
    "bench_b24": ("llama3_600m_bench", 24, 2048,
                  dict(remat_policy="nothing", loss_chunk_size=512)),
    "bench_b32": ("llama3_600m_bench", 32, 2048,
                  dict(remat_policy="nothing", loss_chunk_size=512)),
    "mla_bench": ("deepseek_mla_bench", 8, 2048, {}),
    "v2lite_moe_tiny": ("deepseek_moe_tiny", 4, 64, dict(grad_accum=2)),
    "gemma2_9b": ("gemma2_9b", 1, 8192, dict(loss_chunk_size=512)),
}


@pytest.mark.parametrize("policy", ["dots", "nothing", "attn_out",
                                    "everything"])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_components_equal_tpufw(case, policy):
    name, b, t, kw = TRAIN_CASES[case]
    jcfg, tcfg = _pair(name)
    kw = dict(kw, remat_policy=kw.get("remat_policy", policy))
    _same(T.estimate_train(tcfg, b, t, **kw),
          J.estimate_train(jcfg, b, t, **kw))


@pytest.mark.parametrize("name", ["llama3_8b", "deepseek_mla_bench",
                                  "mixtral_8x7b", "gemma2_9b",
                                  "llama3_600m_bench"])
@pytest.mark.parametrize("kw", [
    dict(cache_len=2048), dict(cache_len=2048, weights_dtype="bfloat16"),
    dict(cache_len=256, n_shards=4), dict(cache_len=512,
                                          weights_dtype="bfloat16"),
], ids=["fp32", "bf16", "shards4", "short_bf16"])
def test_decode_components_equal_tpufw(name, kw):
    jcfg, tcfg = _pair(name)
    for b in (4, 8):
        _same(T.estimate_decode(tcfg, b, **kw), J.estimate_decode(jcfg, b,
                                                                  **kw))


def test_train_components_scale_with_sharding():
    one = T.estimate_train(CFG8B, 16, 2048, n_shards=1)
    sixteen = T.estimate_train(CFG8B, 16, 2048, n_shards=16)
    for field in ("params", "optimizer", "gradients"):
        assert getattr(one, field) == 16 * getattr(sixteen, field)
    assert abs(one.optimizer - 2 * one.params) < 1e-6 * one.params


def test_remat_policy_orders_activation_memory():
    kw = dict(batch_size=8, seq_len=2048, n_shards=1)
    nothing = T.estimate_train(CFG8B, remat_policy="nothing", **kw)
    dots = T.estimate_train(CFG8B, remat_policy="dots", **kw)
    everything = T.estimate_train(CFG8B, remat_policy="everything", **kw)
    assert nothing.activations < dots.activations < everything.activations
    assert dots.activations > 5 * nothing.activations
    with pytest.raises(ValueError, match="unknown remat_policy"):
        T.estimate_train(CFG8B, 8, 2048, remat_policy="most")
    with pytest.raises(ValueError, match="grad_accum"):
        T.estimate_train(CFG8B, 8, 2048, grad_accum=0)


def test_chunked_ce_caps_logits():
    full = T.estimate_train(CFG8B, 8, 2048, loss_chunk_size=None)
    chunked = T.estimate_train(CFG8B, 8, 2048, loss_chunk_size=512)
    assert chunked.logits_ce < full.logits_ce / 3


def test_decode_weights_dtype_halves_params_and_cache_len_scales_kv():
    fp32 = T.estimate_decode(CFG8B, 8, cache_len=2048)
    bf16 = T.estimate_decode(CFG8B, 8, cache_len=2048,
                             weights_dtype="bfloat16")
    assert abs(fp32.params - 2 * bf16.params) < 1e-6 * fp32.params
    assert fp32.kv_cache == bf16.kv_cache
    short = T.estimate_decode(CFG8B, 8, cache_len=256)
    assert abs(fp32.kv_cache - 8 * short.kv_cache) < 1e-6 * fp32.kv_cache


def test_mla_latent_cache_geometry():
    mla = PRESETS["deepseek_mla_bench"]
    _, per_tok = T._attn_geometry(mla)
    assert per_tok == mla.kv_lora_rank + mla.qk_rope_head_dim
    _, mha_tok = T._attn_geometry(CFG8B)
    assert mha_tok == 2 * CFG8B.n_kv_heads * CFG8B.head_dim
    assert mha_tok / per_tok > 3.5
    assert T._attn_geometry(mla) == J._attn_geometry(
        J_DEEPSEEK["deepseek_mla_bench"])


def test_moe_activation_exceeds_dense_equivalent():
    m = T.estimate_train(PRESETS["mixtral_8x7b"], 8, 2048, n_shards=8,
                         remat_policy="dots")
    d = T.estimate_train(CFG8B, 8, 2048, n_shards=8, remat_policy="dots")
    assert m.activations > d.activations


def _cli(module, *args):
    proc = subprocess.run(
        [sys.executable, "-m", module, "--model", "llama3_8b", "--batch",
         "16", "--seq", "2048", "--fsdp", "16", "--ce-chunk", "512",
         "--remat", "nothing", *args],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_emits_tpufws_json_keys_without_a_card():
    """The CLI answers from the static table (the H100 SXM part by
    default) with tpufw's keys and component numbers; ``auto`` needs a
    CUDA device and raises without one."""
    mine = _cli("tpufw_torch.tools.estimate_memory")
    theirs = _cli("tpufw.tools.estimate_memory")
    assert set(mine) == set(theirs)
    for k in ("params", "optimizer", "gradients", "activations",
              "logits_ce", "kv_cache", "total_gib", "model", "mode"):
        assert mine[k] == theirs[k], k
    assert mine["chip"] == "h100_sxm" and mine["chip_hbm_gib"] == 74.5
    assert mine["fits"] is True
    assert _cli("tpufw_torch.tools.estimate_memory", "--chip",
                "h100_pcie")["chip"] == "h100_pcie"
    bad = subprocess.run(
        [sys.executable, "-m", "tpufw_torch.tools.estimate_memory",
         "--model", "llama3_8b", "--batch", "1", "--chip", "v5e"],
        capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "unknown --chip" in bad.stderr
