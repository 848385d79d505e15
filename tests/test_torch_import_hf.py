"""tpufw_torch.tools.import_hf against transformers and tpufw's import_hf:
tiny random-weight HF models (no download) of every family the port has,
Llama with llama3 rope scaling, Qwen-2, Mistral, Mixtral, Gemma-2 and
DeepSeek-V2 dense with and without q_lora_rank and with routed experts
after one dense layer. Config mapping, logits against
transformers and against tpufw's importer (fp32, 2e-4), the port's state
dict equal bit for bit to ``params_from_flax`` of tpufw's tree, export read
back by transformers and by tpufw, the CLI both ways, the loud refusals and
serving an HF directory."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import transformers

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.models import model_for_config as j_model_for_config
from tpufw.tools import import_hf as j_import
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import PRESETS, model_for_config
from tpufw_torch.tools import import_hf
from tpufw_torch.train.checkpoint import load_params

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/conftest.py's assert_trees_close
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=128)


def _llama(rope=True):
    extra = dict(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 32,
    }) if rope else {}
    return transformers.LlamaConfig(
        **SMALL, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=False, **extra)


HF_CONFIGS = {
    "llama_rope_scaled": lambda: _llama(),
    "qwen2": lambda: transformers.Qwen2Config(
        **SMALL, num_key_value_heads=2, rms_norm_eps=1e-6,
        rope_theta=1e6, tie_word_embeddings=False),
    "mistral": lambda: transformers.MistralConfig(
        **SMALL, num_key_value_heads=2, head_dim=16, sliding_window=32,
        rope_theta=10000.0, tie_word_embeddings=False),
    "gemma2": lambda: transformers.Gemma2Config(
        **{**SMALL, "num_hidden_layers": 4}, num_key_value_heads=2,
        head_dim=16, rms_norm_eps=1e-6, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=16,
        sliding_window=32, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True, attention_bias=False),
    "mixtral": lambda: transformers.MixtralConfig(
        **SMALL, num_key_value_heads=2, head_dim=16, num_local_experts=4,
        num_experts_per_tok=2, rope_theta=1e6, tie_word_embeddings=False),
    "deepseek_v2": lambda: transformers.DeepseekV2Config(
        **SMALL, num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        first_k_dense_replace=2, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False),
    # Routed experts from layer 1 on, 2 shared: V2-Lite's layout.
    "deepseek_v2_moe": lambda: transformers.DeepseekV2Config(
        **SMALL, num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe_intermediate_size=48, n_routed_experts=4, num_experts_per_tok=2,
        n_shared_experts=2, first_k_dense_replace=1, topk_method="greedy",
        norm_topk_prob=False, routed_scaling_factor=1.0, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False),
    "deepseek_v2_qlora": lambda: transformers.DeepseekV2Config(
        **SMALL, num_key_value_heads=4, q_lora_rank=24, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        first_k_dense_replace=2, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False),
}
AUTO = {"llama_rope_scaled": transformers.LlamaForCausalLM,
        "qwen2": transformers.Qwen2ForCausalLM,
        "mistral": transformers.MistralForCausalLM,
        "mixtral": transformers.MixtralForCausalLM,
        "gemma2": transformers.Gemma2ForCausalLM,
        "deepseek_v2": transformers.DeepseekV2ForCausalLM,
        "deepseek_v2_moe": transformers.DeepseekV2ForCausalLM,
        "deepseek_v2_qlora": transformers.DeepseekV2ForCausalLM}
# 48 tokens: past the 32-token windows of Mistral and Gemma's local layers.
TOKENS = np.random.default_rng(1).integers(0, 256, (2, 48))


@pytest.fixture(scope="module")
def hf():
    """{family: (HF model, its fp32 logits on TOKENS)}, built once."""
    out = {}
    for i, (name, make) in enumerate(HF_CONFIGS.items()):
        torch.manual_seed(i)
        model = AUTO[name](make()).eval()
        with torch.no_grad():
            logits = model(torch.from_numpy(TOKENS)).logits.numpy()
        out[name] = (model, logits)
    return out


def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, dtype=torch.float32,
                               param_dtype=torch.float32, remat=False, **kw)


def _port_logits(cfg, sd):
    model = model_for_config(cfg, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.from_numpy(TOKENS)).numpy()


def _jax_cfg(hf_cfg):
    import jax.numpy as jnp

    return dataclasses.replace(j_import.config_from_hf(hf_cfg),
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               remat=False)


def _jax_logits(jcfg, params):
    out = jax.jit(j_model_for_config(jcfg).apply)(
        {"params": params}, TOKENS.astype(np.int32))
    # tpufw's Mixtral returns (logits, aux) by default.
    return np.asarray(out[0] if isinstance(out, tuple) else out)


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_config_mapping_matches_tpufw(hf, family):
    model, _ = hf[family]
    cfg = import_hf.config_from_hf(model.config)
    jcfg = j_import.config_from_hf(model.config)
    assert type(cfg).__name__ == type(jcfg).__name__
    skip = {"dtype", "param_dtype", "attention_backend", "remat",
            "remat_policy", "rope_scaling"}
    for f in dataclasses.fields(cfg):
        if f.name not in skip and hasattr(jcfg, f.name):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    rs = getattr(cfg, "rope_scaling", None)
    jrs = getattr(jcfg, "rope_scaling", None)
    assert (rs is None) == (jrs is None)
    if rs is not None:
        mine = dataclasses.asdict(rs)
        theirs = dataclasses.asdict(jrs)
        assert mine == {k: theirs[k] for k in mine}


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_logits_match_transformers_and_tpufw(hf, family):
    """The port's model holding from_hf's weights gives transformers'
    logits and tpufw's (its own importer, its own model), and its state
    dict is params_from_flax of tpufw's tree, bit for bit."""
    model, want = hf[family]
    cfg = _fp32(import_hf.config_from_hf(model.config))
    sd = import_hf.from_hf(model, cfg)
    got = _port_logits(cfg, sd)
    np.testing.assert_allclose(got, want, **TOL)
    jcfg = _jax_cfg(model.config)
    jparams = jax.device_get(j_import.from_hf(model, jcfg))
    np.testing.assert_allclose(got, _jax_logits(jcfg, jparams), **TOL)
    bridged = params_from_flax(jparams, cfg)
    assert bridged.keys() == sd.keys()
    for k in sd:
        assert bridged[k].dtype == sd[k].dtype and torch.equal(
            bridged[k], sd[k]), k


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_export_loads_in_transformers_and_tpufw(hf, family, tmp_path):
    model, want = hf[family]
    cfg = _fp32(import_hf.config_from_hf(model.config))
    sd = import_hf.from_hf(model, cfg)
    info = import_hf.export_hf(sd, cfg, str(tmp_path), max_shard_bytes=60_000)
    assert len(info["files"]) > 2  # sharded, with the index
    back = transformers.AutoModelForCausalLM.from_pretrained(tmp_path).eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            back(torch.from_numpy(TOKENS)).logits.numpy(), want, **TOL)
    hf_cfg = json.loads((tmp_path / "config.json").read_text())
    assert import_hf.config_from_hf(hf_cfg) == import_hf.config_from_hf(
        model.config)
    jcfg = _jax_cfg(hf_cfg)
    jlogits = _jax_logits(jcfg, j_import.from_hf(str(tmp_path), jcfg))
    np.testing.assert_allclose(jlogits, _port_logits(cfg, sd), **TOL)
    # And the port reads its own directory back bit for bit.
    again = import_hf.from_hf(str(tmp_path), cfg)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_bf16_import_keeps_norms_fp32_and_never_widens(hf, tmp_path):
    model, _ = hf["llama_rope_scaled"]
    model16 = AUTO["llama_rope_scaled"](model.config).to(torch.bfloat16)
    model16.load_state_dict({k: v.to(torch.bfloat16)
                             for k, v in model.state_dict().items()})
    model16.save_pretrained(tmp_path, safe_serialization=True)
    cfg = import_hf.config_from_hf(model.config)
    sd = import_hf.from_hf(str(tmp_path), cfg, dtype=torch.bfloat16)
    for k, v in sd.items():
        want = torch.float32 if k.endswith("norm.weight") else torch.bfloat16
        assert v.dtype == want, k
    hf_sd = model16.state_dict()
    assert torch.equal(sd["layers.1.attn.q.weight"],
                       hf_sd["model.layers.1.self_attn.q_proj.weight"])


def test_cli_round_trip(tmp_path):
    """HF dir -> bare params (CLI) -> HF dir (CLI --export llama3_tiny):
    transformers reads back the same logits."""
    torch.manual_seed(7)
    model = transformers.LlamaForCausalLM(_llama(rope=False)).eval()
    model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    assert import_hf.main([str(tmp_path / "hf"), "--out",
                           str(tmp_path / "params")]) == 0
    cfg, sd = load_params(str(tmp_path / "params"))
    assert import_hf.config_from_hf(model.config) == cfg
    assert import_hf.main([str(tmp_path / "params"), "--out",
                           str(tmp_path / "hf2"), "--export",
                           "llama3_tiny"]) == 0
    back = transformers.AutoModelForCausalLM.from_pretrained(
        tmp_path / "hf2").eval()
    with torch.no_grad():
        np.testing.assert_array_equal(
            back(torch.from_numpy(TOKENS)).logits.numpy(),
            model(torch.from_numpy(TOKENS)).logits.numpy())
    # A preset of other widths is refused, not exported.
    with pytest.raises(ValueError, match="different model"):
        import_hf.main([str(tmp_path / "params"), "--out",
                        str(tmp_path / "x"), "--export", "qwen25_tiny"])


def test_cli_export_from_a_training_checkpoint(tmp_path):
    from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches

    cfg = PRESETS["llama3_tiny"]
    trainer = Trainer(cfg, TrainerConfig(
        batch_size=2, seq_len=17, total_steps=2, checkpoint_dir=str(
            tmp_path / "ckpt"), checkpoint_every=2), device="cpu")
    trainer.init_state(seed=0)
    trainer.run(synthetic_batches(2, 17, cfg.vocab_size), 1.0)
    assert import_hf.main([str(tmp_path / "ckpt"), "--out",
                           str(tmp_path / "hf"), "--export",
                           "llama3_tiny"]) == 0
    back = transformers.AutoModelForCausalLM.from_pretrained(tmp_path / "hf")
    want = import_hf.to_hf(trainer.model.state_dict(), cfg)
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k]), k


REFUSED = {
    "deepseek_noaux_tc": ({"model_type": "deepseek_v2", **SMALL,
                           "n_routed_experts": 8, "num_experts_per_tok": 2,
                           "first_k_dense_replace": 1,
                           "topk_method": "noaux_tc"}, "topk_method"),
    "rope_dynamic": ({"model_type": "llama", **SMALL,
                      "rope_scaling": {"rope_type": "dynamic",
                                       "factor": 2.0}}, "dynamic"),
    "rope_longrope": ({"model_type": "llama", **SMALL,
                       "rope_scaling": {"rope_type": "longrope",
                                        "factor": 2.0}}, "longrope"),
    "mlp_bias": ({"model_type": "llama", **SMALL, "mlp_bias": True},
                 "mlp_bias"),
    "qwen_window": ({"model_type": "qwen2", **SMALL,
                     "use_sliding_window": True}, "sliding"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_configs_are_loud(case):
    cfg, match = REFUSED[case]
    with pytest.raises(NotImplementedError, match=match):
        import_hf.config_from_hf(cfg)
    # tpufw refuses the same configs.
    with pytest.raises(NotImplementedError):
        j_import.config_from_hf(cfg)


def test_lora_tree_and_missing_key_are_loud(hf):
    model, _ = hf["llama_rope_scaled"]
    cfg = import_hf.config_from_hf(model.config)
    sd = import_hf.from_hf(model, cfg)
    with pytest.raises(ValueError, match="merge_lora"):
        import_hf.to_hf({**sd, "layers.0.attn.q.weight_lora_a": sd["embed"]},
                        cfg)
    partial = {k: v for k, v in model.state_dict().items()
               if "layers.1.mlp.up_proj" not in k}
    with pytest.raises(KeyError, match="up_proj"):
        import_hf.from_hf(partial, cfg)


def test_serve_from_hf_checkpoint_dir(hf, tmp_path, clear_tpufw_env):
    """TPUFW_HF_CHECKPOINT: the directory's config names the model
    (TPUFW_MODEL is ignored), the weights load in bf16 with fp32 norms,
    restored is True, and run_batch's tokens are generate_text's on the
    same weights."""
    from tpufw_torch.infer import generate_text
    from tpufw_torch.workloads import serve

    model, _ = hf["gemma2"]
    model.save_pretrained(tmp_path, safe_serialization=True)
    for k, v in {"HF_CHECKPOINT": str(tmp_path), "DEVICE": "cpu",
                 "MODEL": "not_a_preset"}.items():
        clear_tpufw_env.setenv(f"TPUFW_{k}", v)
    served, cfg, restored = serve.build_generator()
    assert restored and type(cfg).__name__ == "GemmaConfig"
    assert served.layers[0].attn.q.weight.dtype == torch.bfloat16
    assert served.final_norm.weight.dtype == torch.float32
    prompts = [[1, 5, 9], [2, 3, 4, 5, 6]]
    results = serve.run_batch(prompts, max_new_tokens=4)
    assert [r["output"] for r in results] == generate_text(
        served, prompts, max_new_tokens=4)
    assert all(r["restored_checkpoint"] for r in results)


def test_imported_mixtral_defaults_to_dropless_capacity():
    """tests/test_import_hf.py's rule: an imported Mixtral's capacity
    factor is its expert count, so no token drops."""
    cfg = import_hf.config_from_hf({
        "model_type": "mixtral", "vocab_size": 64, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 48, "num_local_experts": 8,
        "num_experts_per_tok": 2})
    assert type(cfg).__name__ == "MixtralConfig"
    assert cfg.capacity_factor == 8.0 and cfg.n_experts == 8


def test_serve_mixtral_hf_checkpoint_dir(hf, tmp_path, clear_tpufw_env):
    """A bf16 Mixtral directory through TPUFW_HF_CHECKPOINT: a Mixtral
    decode model (TPUFW_MODEL ignored), each expert slice equal to its HF
    expert, norms fp32, run_batch's tokens generate_text's; under
    TPUFW_QUANTIZE=int8 the codes and scales equal quantize_model of the
    bf16 load."""
    from tpufw_torch.infer import generate_text
    from tpufw_torch.models import Mixtral
    from tpufw_torch.workloads import serve

    model, _ = hf["mixtral"]
    model16 = AUTO["mixtral"](model.config).to(torch.bfloat16)
    model16.load_state_dict({k: v.to(torch.bfloat16)
                             for k, v in model.state_dict().items()})
    model16.save_pretrained(tmp_path, safe_serialization=True)
    for k, v in {"HF_CHECKPOINT": str(tmp_path), "DEVICE": "cpu",
                 "MODEL": "not_a_preset"}.items():
        clear_tpufw_env.setenv(f"TPUFW_{k}", v)
    served, cfg, restored = serve.build_generator()
    assert restored and isinstance(served, Mixtral)
    assert cfg.capacity_factor == cfg.n_experts == 4
    hf_sd = model16.state_dict()
    moe = served.layers[1].moe
    assert moe.w_up.dtype == torch.bfloat16
    assert served.layers[1].moe_norm.weight.dtype == torch.float32
    assert torch.equal(
        moe.w_up[3],
        hf_sd["model.layers.1.block_sparse_moe.experts.3.w3.weight"])
    assert torch.equal(
        moe.router.weight, hf_sd["model.layers.1.block_sparse_moe.gate.weight"])
    prompts = [[1, 5, 9], [2, 3, 4, 5, 6]]
    results = serve.run_batch(prompts, max_new_tokens=4)
    assert [r["output"] for r in results] == generate_text(
        served, prompts, max_new_tokens=4)
    want = serve.quantize_model(served).state_dict()
    clear_tpufw_env.setenv("TPUFW_QUANTIZE", "int8")
    qmodel, qcfg, _ = serve.build_generator()
    got = qmodel.state_dict()
    assert qcfg.quantized_weights and got.keys() == want.keys()
    assert got["layers.0.moe.w_gate.weight"].dtype == torch.int8
    assert all(torch.equal(got[k], want[k]) for k in want)
