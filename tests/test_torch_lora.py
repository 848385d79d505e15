"""tpufw_torch LoRA vs tpufw: adapters on every projection and expert
stack, the adapter-only optimizer, merge_lora, the import -> LoRA train ->
merge -> export loop, and the refusals. CPU, fp32, tiny presets; weights
cross from the Flax trees through ``params_from_flax``.

Tolerances: logits 2e-4 (``tests/conftest.py``'s tree tolerance, as the
port's model parity tests); 3-step trainer losses rtol 1e-4, as
``test_torch_trainer.py``'s trajectory test; merged weights 1e-6 against
``tpufw.models.lora.merge_lora``; merged vs unmerged forward 1e-5, as
``tests/test_lora.py``.
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
from flax.core import meta

from tpufw.mesh import MeshConfig
from tpufw.models import GEMMA_CONFIGS as J_GEMMA
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.models import MIXTRAL_CONFIGS as J_MIXTRAL
from tpufw.models import Gemma as JGemma
from tpufw.models import Llama as JLlama
from tpufw.models import Mixtral as JMixtral
from tpufw.models.lora import merge_lora as j_merge_lora
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import (
    DEEPSEEK_CONFIGS,
    GEMMA_CONFIGS,
    LLAMA_CONFIGS,
    MIXTRAL_CONFIGS,
    model_for_config,
)
from tpufw_torch.models.lora import has_lora, is_lora_name, merge_lora
from tpufw_torch.train import Trainer, TrainerConfig
from tpufw_torch.train import data as t_data
from tpufw_torch.train.checkpoint import load_params, save_params

TOL = dict(rtol=2e-4, atol=2e-4)
RANK = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models run one intra-op thread: many threads of several test
    workers on one host's cores spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# name: (JAX config, port config, JAX model class, overrides of both).
FAMILIES = {
    "llama": (J_LLAMA["llama3_tiny"], LLAMA_CONFIGS["llama3_tiny"], JLlama,
              {}),
    "gemma_pairs": (J_GEMMA["gemma2_tiny"], GEMMA_CONFIGS["gemma2_tiny"],
                    JGemma, {}),
    # Dropless capacity: the merge must not depend on evictions.
    "mixtral_einsum": (J_MIXTRAL["mixtral_tiny"],
                       MIXTRAL_CONFIGS["mixtral_tiny"], JMixtral,
                       {"capacity_factor": 4.0, "moe_dispatch": "einsum"}),
    "mixtral_sorted": (J_MIXTRAL["mixtral_tiny"],
                       MIXTRAL_CONFIGS["mixtral_tiny"], JMixtral,
                       {"capacity_factor": 4.0, "moe_dispatch": "sorted"}),
}


def _pair(family="llama", rank=RANK, scan=True):
    jc, tc, jcls, kw = FAMILIES[family]
    jc = dataclasses.replace(jc, dtype=jnp.float32, param_dtype=jnp.float32,
                             lora_rank=rank, scan_layers=scan, **kw)
    tc = dataclasses.replace(tc, dtype=torch.float32,
                             param_dtype=torch.float32, lora_rank=rank, **kw)
    return jc, tc, jcls


def _tokens(n=2, t=16, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, t))


@functools.lru_cache(maxsize=None)
def _init(jc, jcls, seed):
    """Host Flax params of ``jc`` from ``seed``, made once a process (the
    tests never mutate them)."""
    return jax.device_get(meta.unbox(jax.jit(jcls(jc).init)(
        jax.random.key(seed), jnp.asarray(_tokens()))["params"]))


def _flax(jc, jcls, seed=1, tweak_b=0.0):
    """Host Flax params of ``jc`` (init from ``seed``; both MoE dispatch
    modes share one init, whose tree is the same); ``tweak_b`` adds seeded
    noise of that scale to every adapter B, so a merge has a real delta to
    fold."""
    if hasattr(jc, "moe_dispatch"):
        jc = dataclasses.replace(jc, moe_dispatch="einsum")
    p = _init(jc, jcls, seed)
    if not tweak_b:
        return p
    rng = np.random.default_rng(seed)

    def tweak(path, x):
        if any(str(getattr(k, "key", "")).endswith("_lora_b") for k in path):
            return x + tweak_b * rng.standard_normal(x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(tweak, p)


def _jax_logits(jc, jcls, params, tokens):
    out = jax.jit(lambda p, t: jcls(jc).apply({"params": p}, t))(
        params, jnp.asarray(tokens))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _port(tc, state):
    m = model_for_config(tc, device="cpu")
    m.load_state_dict(state)
    return m


def _logits(model, tokens):
    with torch.no_grad():
        return model(torch.as_tensor(tokens)).numpy()


def test_rank0_has_no_adapters():
    """Rank 0 has no adapter; rank r has one pair per projection and per
    expert stack, the keys params_from_flax gives for tpufw's tree, and
    only they need gradients."""
    for family in FAMILIES:
        _, tc, _ = _pair(family, rank=0)
        assert not has_lora(model_for_config(tc, device="meta").state_dict())
    jc, tc, jcls = _pair("mixtral_einsum")
    model = model_for_config(tc, device="cpu")
    sd = model.state_dict()
    assert sd.keys() == params_from_flax(_flax(jc, jcls), tc).keys()
    assert sd["layers.0.moe.w_gate_lora_a"].shape == (4, RANK, 64)
    assert sd["layers.0.moe.w_down_lora_b"].shape == (4, 64, RANK)
    assert not any(k.startswith("layers.0.moe.router.") and is_lora_name(k)
                   for k in sd)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == {k for k in sd if is_lora_name(k)}
    assert len(trainable) == 2 * tc.n_layers * (4 + 3)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_equals_base(family):
    """B = 0: the LoRA model is its base bit for bit, the rank-0 model of
    the same seed (the adapters draw from a stream of their own, as
    tpufw's per-parameter keys leave its base alone)."""
    _, tc, _ = _pair(family)
    tokens = _tokens()
    lora = model_for_config(tc, device="cpu", seed=5)
    base = model_for_config(dataclasses.replace(tc, lora_rank=0),
                            device="cpu", seed=5)
    np.testing.assert_array_equal(_logits(lora, tokens), _logits(base, tokens))
    assert all(not v.any() for k, v in lora.state_dict().items()
               if k.endswith("_lora_b"))
    assert all(v.any() for k, v in lora.state_dict().items()
               if k.endswith("_lora_a"))


def test_trainer_losses_match_tpufw(devices8):
    """Three LoRA steps of llama3_tiny from tpufw's init: the port's
    losses equal tpufw's Trainer's (rtol 1e-4), whose multi_transform
    trains the adapters and zeroes the base."""
    jc, tc, jcls = _pair("llama")
    kw = dict(batch_size=8, seq_len=17, total_steps=3, lr=1e-2,
              warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32")
    jt = JTrainer(jcls(jc), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(jt.state.params)
    j_hist = jt.run(t_data.synthetic_batches(8, 17, 256, seed=3),
                    model_flops_per_token=jc.flops_per_token(16))
    tt = Trainer(tc, TrainerConfig(**kw), device="cpu")
    tt.init_state(state_dict=params_from_flax(params, tc))
    t_hist = tt.run(t_data.synthetic_batches(8, 17, 256, seed=3),
                    model_flops_per_token=tc.flops_per_token(16))
    np.testing.assert_allclose([m.loss for m in t_hist],
                               [m.loss for m in j_hist], rtol=1e-4)
    # And the trained adapters give tpufw's trained model's logits.
    tokens = _tokens(seed=4)
    np.testing.assert_allclose(
        _logits(tt.model, tokens),
        _jax_logits(jc, jcls, jax.device_get(jt.state.params), tokens),
        **TOL)


def test_training_updates_only_adapters(tmp_path):
    """Only adapters move, and still only they after a resume: the model
    that maybe_restore rebuilds on ``meta`` keeps the base frozen."""
    _, tc, _ = _pair("mixtral_sorted")
    kw = dict(batch_size=4, seq_len=17, lr=1e-2, warmup_steps=1,
              checkpoint_dir=str(tmp_path), checkpoint_every=2,
              handle_preemption=False)
    first = Trainer(tc, TrainerConfig(total_steps=2, **kw), device="cpu")
    before = {k: v.clone() for k, v in first.init_state(seed=0)
              .state_dict().items()}
    first.run(t_data.synthetic_batches(4, 17, 256, seed=1),
              model_flops_per_token=1.0)
    resumed = Trainer(tc, TrainerConfig(total_steps=4, **kw), device="cpu")
    assert resumed.maybe_restore() and resumed.step == 2
    trainable = {n for n, p in resumed.model.named_parameters()
                 if p.requires_grad}
    assert trainable == {k for k in before if is_lora_name(k)}
    assert {id(p) for p in resumed.optimizer.params} == {
        id(p) for n, p in resumed.model.named_parameters()
        if n in trainable}
    resumed.run(t_data.synthetic_batches(4, 17, 256, seed=2),
                model_flops_per_token=1.0)
    after = resumed.model.state_dict()
    for k, v in before.items():
        if is_lora_name(k):
            assert not torch.equal(v, after[k]), f"adapter {k} never moved"
        else:
            assert torch.equal(v, after[k]), f"base tensor {k} moved"


@pytest.mark.parametrize("family, scan", [
    ("llama", True), ("llama", False), ("gemma_pairs", True),
    ("mixtral_einsum", True),
    ("mixtral_sorted", True)])
def test_merge_matches_tpufw(family, scan):
    """With tpufw's weights and nonzero B the port's logits are tpufw's;
    the port's merge_lora equals tpufw's on the same adapters (1e-6),
    scanned stacks and Gemma's pairs included; and the merged rank-0
    model reproduces the tuned forward (1e-5), in both dispatch modes."""
    jc, tc, jcls = _pair(family, scan=scan)
    params = _flax(jc, jcls, tweak_b=0.05)
    tokens = _tokens(seed=3)
    tuned = _logits(_port(tc, params_from_flax(params, tc)), tokens)
    np.testing.assert_allclose(tuned, _jax_logits(jc, jcls, params, tokens),
                               **TOL)
    tc0 = dataclasses.replace(tc, lora_rank=0)
    want = params_from_flax(j_merge_lora(params, rank=RANK,
                                         alpha=jc.lora_alpha), tc0)
    got = merge_lora(params_from_flax(params, tc), rank=RANK,
                     alpha=tc.lora_alpha)
    assert got.keys() == want.keys() and not has_lora(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_logits(_port(tc0, got), tokens), tuned,
                               rtol=1e-5, atol=1e-5)


def test_merge_without_adapters_is_loud():
    _, tc, _ = _pair("llama", rank=0)
    sd = model_for_config(tc, device="cpu").state_dict()
    with pytest.raises(ValueError, match="no .*lora"):
        merge_lora(sd, rank=4, alpha=16.0)
    _, tc, _ = _pair("llama")
    sd = model_for_config(tc, device="cpu").state_dict()
    with pytest.raises(ValueError, match="rank=8 but .* rank 4"):
        merge_lora(sd, rank=8, alpha=16.0)
    with pytest.raises(TypeError):
        merge_lora(sd, rank=4)  # alpha is required
    for drop in ("layers.0.attn.q.weight", "layers.0.attn.q.weight_lora_b"):
        with pytest.raises(ValueError, match="layers.0.attn.q.weight_lora_a"):
            merge_lora({k: v for k, v in sd.items() if k != drop}, alpha=16.0)


def test_init_from_base_directory(tmp_path):
    """Bare params of the rank-0 model start a LoRA trainer: the base from
    the directory, adapters drawn from the seed with B = 0, so step 0's
    logits are the base's; it then trains adapters only."""
    _, tc, _ = _pair("llama")
    tc0 = dataclasses.replace(tc, lora_rank=0)
    base = model_for_config(tc0, device="cpu", seed=7)
    save_params(str(tmp_path / "base"), base.state_dict(), tc0)
    trainer = Trainer(tc, TrainerConfig(batch_size=4, seq_len=17,
                                        total_steps=2, lr=1e-2,
                                        warmup_steps=1), device="cpu")
    model = trainer.init_from_params(str(tmp_path / "base"), seed=3)
    tokens = _tokens(seed=8)
    np.testing.assert_array_equal(_logits(model, tokens),
                                  _logits(base, tokens))
    sd = model.state_dict()
    drawn = model_for_config(tc, device="cpu", seed=3).state_dict()
    for k in sd:
        if is_lora_name(k):
            # The adapters a model built from the same seed draws.
            torch.testing.assert_close(sd[k], drawn[k], rtol=0, atol=0)
    assert all(sd[k].any() for k in sd if k.endswith("_lora_a"))
    assert [p.requires_grad for p in model.parameters()] == [
        is_lora_name(n) for n, _ in model.named_parameters()]
    hist = trainer.run(t_data.synthetic_batches(4, 17, 256, seed=1),
                       model_flops_per_token=1.0)
    assert len(hist) == 2 and np.isfinite(hist[-1].loss)
    with pytest.raises(ValueError, match="a different model"):
        Trainer(dataclasses.replace(tc, n_layers=1), TrainerConfig(),
                device="cpu").init_from_params(str(tmp_path / "base"))


def test_merge_cli_on_port_checkpoint(tmp_path, capsys, monkeypatch):
    """The merge CLI turns the Trainer's own checkpoint step into merged
    bare params (config with lora_rank 0) whose forward is the tuned
    model's, which the serve workload loads (TPUFW_PARAMS_CHECKPOINT) and
    the import_hf CLI exports."""
    from tpufw_torch.tools import import_hf
    from tpufw_torch.tools import merge_lora as cli
    from tpufw_torch.workloads import serve

    _, tc, _ = _pair("llama")
    trainer = Trainer(tc, TrainerConfig(
        batch_size=4, seq_len=17, total_steps=2, lr=1e-2, warmup_steps=1,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
        handle_preemption=False), device="cpu")
    trainer.init_state(seed=0)
    trainer.run(t_data.synthetic_batches(4, 17, 256, seed=1),
                model_flops_per_token=1.0)
    out = str(tmp_path / "merged")
    assert cli.main([str(tmp_path / "ck" / "2"), "--out", out,
                     "--alpha", str(tc.lora_alpha)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg, merged = load_params(out)
    assert line["out"] == out and cfg.lora_rank == 0 and not has_lora(merged)
    assert line["n_params"] == sum(t.numel() for t in merged.values())
    tokens = _tokens(seed=11)
    np.testing.assert_allclose(_logits(_port(cfg, merged), tokens),
                               _logits(trainer.model, tokens),
                               rtol=1e-5, atol=1e-5)
    _env(monkeypatch, PARAMS_CHECKPOINT=out)
    model, _, restored = serve.build_generator()
    assert restored
    torch.testing.assert_close(model.state_dict()["layers.0.attn.q.weight"],
                               merged["layers.0.attn.q.weight"])
    assert import_hf.main([out, "--out", str(tmp_path / "hf"),
                           "--export", "llama3_tiny"]) == 0
    assert json.loads(capsys.readouterr().out)["n_params"] == \
        line["n_params"]
    # Bare params of the LoRA model merge the same way.
    save_params(str(tmp_path / "bare"), trainer.model.state_dict(), tc)
    assert cli.main([str(tmp_path / "bare"), "--out", str(tmp_path / "m2"),
                     "--rank", str(RANK), "--alpha", "16"]) == 0
    for k, v in load_params(str(tmp_path / "m2"))[1].items():
        torch.testing.assert_close(v, merged[k], rtol=0, atol=0)


def test_full_interop_loop(tmp_path):
    """HF import -> LoRA fine-tune from the imported base -> merge ->
    export_hf -> transformers reload gives the fine-tuned logits, which
    moved off the base's."""
    import transformers

    from tpufw_torch.tools.import_hf import config_from_hf, export_hf, from_hf

    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, rope_theta=500000.0,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(1)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=torch.float32)
    save_params(str(tmp_path / "base"), from_hf(hf_model, cfg), cfg)
    lcfg = dataclasses.replace(cfg, lora_rank=RANK)
    trainer = Trainer(lcfg, TrainerConfig(batch_size=4, seq_len=17,
                                          total_steps=3, lr=1e-2,
                                          warmup_steps=1), device="cpu")
    trainer.init_from_params(str(tmp_path / "base"))
    trainer.run(t_data.synthetic_batches(4, 17, 256),
                model_flops_per_token=1.0)
    merged = merge_lora(trainer.model.state_dict(), alpha=lcfg.lora_alpha)
    export_hf(merged, cfg, str(tmp_path / "hf"))
    reloaded = transformers.LlamaForCausalLM.from_pretrained(
        tmp_path / "hf").eval()
    tokens = _tokens(seed=7, t=17)
    with torch.no_grad():
        got = reloaded(torch.as_tensor(tokens)).logits.numpy()
        base = hf_model(torch.as_tensor(tokens)).logits.numpy()
    np.testing.assert_allclose(got, _logits(_port(cfg, merged), tokens),
                               atol=2e-4, rtol=2e-3)
    assert np.abs(got - base).max() > 1e-3


def test_export_unmerged_lora_is_loud():
    from tpufw.tools.import_hf import to_hf as j_to_hf
    from tpufw_torch.tools.import_hf import to_hf

    jc, tc, jcls = _pair("llama")
    params = _flax(jc, jcls)
    with pytest.raises(ValueError, match="merge_lora"):
        to_hf(params_from_flax(params, tc), tc)
    with pytest.raises(ValueError, match="merge_lora"):
        j_to_hf(params, jc)
    # MLA's kv_lora_rank names carry no adapter: DeepSeek still exports.
    assert not has_lora(model_for_config(
        DEEPSEEK_CONFIGS["deepseek_tiny_qlora"], device="meta").state_dict())


@pytest.mark.parametrize("mode", ["einsum", "sorted"])
def test_mixtral_expert_lora_grads(mode):
    """Expert-stack and attention adapters under each dispatch: every
    adapter's gradient equals tpufw's (the logits are
    test_merge_matches_tpufw's), and the base gets none."""
    jc, tc, jcls = _pair(f"mixtral_{mode}")
    params = _flax(jc, jcls, tweak_b=0.05)
    tokens = _tokens()
    r = np.random.default_rng(2).standard_normal(
        (2, 16, jc.vocab_size)).astype(np.float32)

    def j_loss(p):
        return jnp.sum(jcls(jc).apply({"params": p},
                                      jnp.asarray(tokens))[0] * r)

    j_grads = params_from_flax(
        jax.device_get(jax.jit(jax.grad(j_loss))(params)), tc)
    model = _port(tc, params_from_flax(params, tc))
    logits = model(torch.as_tensor(tokens))
    (logits * torch.as_tensor(r)).sum().backward()
    for n, p in model.named_parameters():
        if is_lora_name(n):
            np.testing.assert_allclose(p.grad.numpy(), j_grads[n].numpy(),
                                       err_msg=n, **TOL)
        else:
            assert p.grad is None, n


def test_int8_refuses_lora():
    """quantize_params refuses adapters (merge first) and so does an int8
    model with lora_rank > 0, in tpufw's words."""
    from tpufw.ops.quant import quantize_params as j_quantize
    from tpufw_torch.ops.quant import quantize_params

    jc, tc, jcls = _pair("mixtral_einsum")
    params = _flax(jc, jcls)
    with pytest.raises(ValueError, match="merge_lora first"):
        quantize_params(params_from_flax(params, tc))
    with pytest.raises(ValueError, match="merge_lora first"):
        j_quantize(params)
    merged = merge_lora(params_from_flax(params, tc), alpha=16.0)
    assert any(v.dtype == torch.int8
               for v in quantize_params(merged).values())
    for name in ("llama", "mixtral_einsum"):
        _, tc, _ = _pair(name)
        with pytest.raises(ValueError, match="merge the adapters"):
            model_for_config(dataclasses.replace(tc, quantized_weights=True),
                             device="cpu")


def _env(monkeypatch, **env):
    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    base = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="2",
                SEQ_LEN="17", LOSS_CHUNK_SIZE="8", HANDLE_PREEMPTION="0")
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(f"TPUFW_{k}", str(v))


@pytest.mark.parametrize("model", ["llama3_tiny", "gemma2_tiny",
                                   "mixtral_tiny"])
def test_lora_knobs_are_honoured(monkeypatch, capsys, model):
    """TPUFW_LORA_RANK/ALPHA give tpufw's model config, and the workload
    trains the adapters alone for two finite steps."""
    from tpufw.workloads import train_llama as j_train_llama
    from tpufw_torch.workloads import train_llama

    _env(monkeypatch, MODEL=model, LORA_RANK=4, LORA_ALPHA=8,
         TOTAL_STEPS=2, WARMUP_STEPS=1)
    trainer, cfg = train_llama.build_trainer()
    _, jcfg = j_train_llama.build_trainer()
    assert (cfg.lora_rank, cfg.lora_alpha) == (jcfg.lora_rank,
                                               jcfg.lora_alpha) == (4, 8.0)
    assert train_llama.main() == 0
    steps = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"step"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)


def test_lora_knob_on_deepseek_raises(monkeypatch):
    from tpufw.workloads import train_llama as j_train_llama
    from tpufw_torch.workloads import train_llama

    _env(monkeypatch, MODEL="deepseek_tiny", LORA_RANK=4)
    with pytest.raises(NotImplementedError, match="TPUFW_LORA_RANK"):
        train_llama.build_trainer()
    with pytest.raises(NotImplementedError, match="TPUFW_LORA_RANK"):
        j_train_llama.build_trainer()
    # A rank of 0 with an alpha is no LoRA: it trains as it did.
    _env(monkeypatch, MODEL="deepseek_tiny", LORA_ALPHA=32)
    assert train_llama.build_trainer()[1] == DEEPSEEK_CONFIGS["deepseek_tiny"]


def test_init_from_with_lora_knob(monkeypatch, tmp_path, capsys):
    """TPUFW_INIT_FROM with TPUFW_LORA_RANK: the base from bare params,
    adapters from TPUFW_SEED."""
    from tpufw_torch.workloads import train_llama

    cfg = LLAMA_CONFIGS["llama3_tiny"]
    save_params(str(tmp_path), model_for_config(cfg, device="cpu",
                                                 seed=4).state_dict(), cfg)
    _env(monkeypatch, LORA_RANK=4, INIT_FROM=str(tmp_path), TOTAL_STEPS=1)
    assert train_llama.main() == 0
    assert f"initialized params from {tmp_path}" in capsys.readouterr().out


def test_lora_train_slice():
    """Llama-3-8B LoRA at all 32 layers: rank 16 on the seven projections,
    41,943,040 adapter parameters, reachable by name with the slice's
    trainer defaults."""
    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.configs.presets import (
        TRAIN_SLICES,
        llama3_8b_lora_train_slice,
    )

    cfg, tcfg = llama3_8b_lora_train_slice()
    assert (cfg.n_layers, cfg.lora_rank, cfg.lora_alpha, cfg.d_model) == (
        32, 16, 16.0, 4096)
    assert (tcfg.batch_size, tcfg.seq_len, tcfg.loss_chunk_size) == (
        2, 2048, 512)
    assert cfg.remat and cfg.attention_backend == "flash"
    assert resolve_model_preset("llama3_8b_lora_train_slice") == cfg
    assert "llama3_8b_lora_train_slice" in TRAIN_SLICES
    model = model_for_config(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert n == 41_943_040
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params() + n
