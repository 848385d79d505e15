"""tpufw_torch DeepSeek MoE vs the tpufw Flax Deepseek in fp32, with the
Flax weights moved into the port through ``params_from_flax`` (norm scales
drawn at random so that a norm read from the wrong place shows).

On ``deepseek_moe_tiny`` (every layer MoE, a scanned tree) and a
``first_k_dense=1`` variant (layer 0 dense, an unscanned tree), at
tests/conftest.py's 2e-4 unless stated: logits and the router aux (divided
by every layer, dense ones included) in both dispatch modes with left
padding and a capacity that drops tokens; gradients; three trainer steps;
the analytic counts with the active experts; the mixed-stack error; cached
decode against prefill; group-limited routing; int8 codes and logits and
the serve workload's ``quantize_model``; HF
``DeepseekV2ForCausalLM`` logits against the port and ``tpufw``'s
``from_hf``; the export round trip with MoE and yarn; the dispatch knob of
the train workload; and DeepSeek-V2-Lite's preset, which is the port's
import of its published config.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig
from tpufw.models.deepseek import DEEPSEEK_CONFIGS as J_CONFIGS
from tpufw.models.deepseek import Deepseek as JDeepseek
from tpufw.models.deepseek import YarnScaling as JYarn
from tpufw.ops import quant as j_quant
from tpufw.tools import import_hf as j_import
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train.trainer import batch_loss as j_batch_loss
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import DEEPSEEK_CONFIGS, Deepseek
from tpufw_torch.models.deepseek import YarnScaling
from tpufw_torch.ops import quant
from tpufw_torch.tools import import_hf
from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
from tpufw_torch.train.trainer import batch_loss

TOL = dict(rtol=2e-4, atol=2e-4)
T = 40
# The two stacks: every layer MoE (scanned in tpufw), and layer 0 dense
# of three (unscanned, as tpufw imports V2-Lite).
STACKS = {"all_moe": dict(),
          "first_dense": dict(first_k_dense=1, n_layers=3,
                              scan_layers=False)}
MODES = [(s, m) for s in STACKS for m in ("einsum", "sorted")]


def _pair(stack="all_moe", **overrides):
    """(JAX config, port config) of deepseek_moe_tiny in fp32."""
    over = {**STACKS[stack], **overrides}
    jcfg = dataclasses.replace(
        J_CONFIGS["deepseek_moe_tiny"], dtype=jnp.float32,
        param_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(
        DEEPSEEK_CONFIGS["deepseek_moe_tiny"], dtype=torch.float32,
        param_dtype=torch.float32, **over)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _flax_params(stack="all_moe"):
    jcfg, _ = _pair(stack)
    params = jax.jit(JDeepseek(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.device_get(meta.unbox(params))
    rng = np.random.default_rng(7)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (fill(v) if k != "scale" else
                        (1.0 + 0.1 * rng.standard_normal(np.shape(v))
                         ).astype(np.float32))
                    for k, v in tree.items()}
        return tree

    return fill(params)


def _port(tcfg, params):
    model = Deepseek(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params, tcfg))
    return model


def _batch(seed=0):
    """tokens [2, T] and segment ids with row 1 left-padded by 9."""
    tokens = np.random.default_rng(seed).integers(0, 256, (2, T))
    seg = np.ones((2, T), np.int32)
    seg[1, :9] = 0
    return tokens.astype(np.int32), seg


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------


@pytest.mark.parametrize("stack, mode", MODES,
                         ids=[f"{s}-{m}" for s, m in MODES])
def test_logits_and_aux_match_flax(stack, mode):
    """Capacity 1.0 drops tokens, so the routing order and the valid mask
    (segment 0 takes no capacity) must be tpufw's."""
    jcfg, tcfg = _pair(stack, moe_dispatch=mode, capacity_factor=1.0)
    params = _flax_params(stack)
    model = _port(tcfg, params)
    assert set(params_from_flax(params, tcfg)) == set(model.state_dict())
    dense = [i for i, b in enumerate(model.layers) if hasattr(b, "mlp")]
    assert dense == list(range(tcfg.first_k_dense))
    tokens, seg = _batch()
    want, want_aux = jax.jit(JDeepseek(jcfg).apply)(
        {"params": params}, jnp.asarray(tokens), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens),
                         segment_ids=torch.from_numpy(seg), return_aux=True)
        plain = model(torch.from_numpy(tokens),
                      segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # tpufw divides by n_layers, the dense layer included.
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("mode", ["einsum", "sorted"])
def test_gradients_match_jax(mode):
    jcfg, tcfg = _pair("first_dense", moe_dispatch=mode, capacity_factor=1.0)
    params = _flax_params("first_dense")
    tokens, seg = _batch(1)
    r = np.random.default_rng(2).standard_normal((2, T, 256)).astype(
        np.float32)

    def j_loss(p):
        lg, aux = JDeepseek(jcfg).apply({"params": p}, jnp.asarray(tokens),
                                        segment_ids=jnp.asarray(seg))
        return (lg * r).sum() + aux

    want = params_from_flax(jax.device_get(jax.jit(jax.grad(j_loss))(params)),
                            tcfg)
    model = _port(tcfg, params)
    lg, aux = model(torch.from_numpy(tokens),
                    segment_ids=torch.from_numpy(seg), return_aux=True)
    ((lg * torch.from_numpy(r)).sum() + aux).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("chunk", [None, 16], ids=["full_logits", "chunked"])
def test_batch_loss_adds_aux_as_jax(chunk):
    """The trainer's objective takes a DeepSeek MoE's router loss on both
    loss paths, as tpufw's does."""
    jcfg, tcfg = _pair("first_dense")
    params = _flax_params("first_dense")
    tokens, seg = _batch(3)
    jb = {"tokens": jnp.asarray(tokens), "segment_ids": jnp.asarray(seg)}
    want, wn = jax.jit(lambda p, b: j_batch_loss(
        JDeepseek(jcfg).apply, p, b, chunk, "float32"))(params, jb)
    model = _port(tcfg, params)
    tb = {"tokens": torch.from_numpy(tokens),
          "segment_ids": torch.from_numpy(seg)}
    with torch.no_grad():
        got, n = batch_loss(model, tb, chunk, "float32")
        _, aux = model(tb["tokens"][:, :-1],
                       segment_ids=tb["segment_ids"][:, :-1], return_aux=True)
    assert float(n) == float(wn)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(aux) > 0.0


def test_three_trainer_steps_match_flax(devices8):
    """Same init, same synthetic batches, same optimizer, chunked CE with
    the aux loss in the objective: every step's loss within 1e-4
    relative (the rule of test_torch_trainer.py)."""
    jcfg, tcfg = _pair("first_dense")
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=1e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    jt = JTrainer(JDeepseek(jcfg), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(meta.unbox(jt.state.params))
    j_hist = jt.run(synthetic_batches(8, 33, jcfg.vocab_size, seed=3),
                    model_flops_per_token=jcfg.flops_per_token(32))
    tt = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    model = tt.init_state(state_dict=params_from_flax(params, tcfg))
    assert isinstance(model, Deepseek)
    t_hist = tt.run(synthetic_batches(8, 33, tcfg.vocab_size, seed=3),
                    model_flops_per_token=tcfg.flops_per_token(32))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose(
        [m.loss for m in t_hist], [m.loss for m in j_hist], rtol=1e-4)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_param_and_active_flop_counts_match_jax(stack):
    """The port's model holds JAX's n_params parameters, and the FLOPs
    count only the k active routed experts."""
    jcfg, tcfg = _pair(stack)
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_params(False) == jcfg.n_params(False)
    assert tcfg.flops_per_token(2047) == jcfg.flops_per_token(2047)
    model = Deepseek(tcfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == tcfg.n_params()
    assert tcfg.n_experts == tcfg.n_routed_experts == 4
    all_active = dataclasses.replace(tcfg, experts_per_token=4)
    assert tcfg.flops_per_token(64) < all_active.flops_per_token(64)
    dense = dataclasses.replace(tcfg, n_routed_experts=0)
    assert dense.flops_per_token(64) != tcfg.flops_per_token(64)


def test_mixed_stack_needs_unscanned_layout():
    """As in tpufw: first_k_dense > 0 with scan_layers raises; the
    unscanned layout builds."""
    base = DEEPSEEK_CONFIGS["deepseek_moe_tiny"]
    with pytest.raises(ValueError, match="scan_layers"):
        dataclasses.replace(base, first_k_dense=1)
    with pytest.raises(ValueError, match="scan_layers"):
        dataclasses.replace(J_CONFIGS["deepseek_moe_tiny"], first_k_dense=1)
    cfg = dataclasses.replace(base, first_k_dense=1, scan_layers=False)
    model = Deepseek(cfg, device="meta")
    assert hasattr(model.layers[0], "mlp") and hasattr(model.layers[1], "moe")


def test_cached_decode_matches_prefill():
    """At a dropless capacity (the imports'), a prompt prefilled through
    the latent cache and then fed one token at a time gives the uncached
    forward's logits at every position."""
    _, tcfg = _pair("first_dense", capacity_factor=4.0)
    model = _port(tcfg.decode_config(), _flax_params("first_dense"))
    tokens = torch.from_numpy(_batch(4)[0][:1]).long()
    n = 24
    with torch.no_grad():
        want = model(tokens)
        cache = model.init_cache(1, length=64)
        got = [model(tokens[:, :n], cache=cache)]
        for j in range(n, T):
            got.append(model(tokens[:, j:j + 1], torch.tensor([[j]]),
                             cache=cache))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               **TOL)


def test_group_limited_routing_matches_jax():
    """8 experts in 4 groups, the best 2 groups routable, top 3: the group
    limit excludes whole groups every token."""
    over = dict(n_routed_experts=8, experts_per_token=3, n_group=4,
                topk_group=2, capacity_factor=8.0)
    jcfg, tcfg = _pair(**over)
    params = jax.device_get(meta.unbox(jax.jit(JDeepseek(jcfg).init)(
        jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]))
    model = _port(tcfg, params)
    assert model.layers[0].moe.routed.group_limit == (4, 2)
    tokens, seg = _batch(6)
    want, want_aux = jax.jit(JDeepseek(jcfg).apply)(
        {"params": params}, jnp.asarray(tokens), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens),
                         segment_ids=torch.from_numpy(seg), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_int8_codes_and_logits_match_jax():
    """quantize_params covers the routed stacks per (expert, out-channel)
    and the shared MLP as projections, routers and kv_b staying fp: the
    codes equal tpufw's, and a tpufw int8 tree moved through
    params_from_flax gives tpufw's int8 logits."""
    jcfg, tcfg = _pair("first_dense", quantized_weights=True)
    fp = _flax_params("first_dense")
    jq = jax.device_get(j_quant.quantize_params(fp))
    want = params_from_flax(jq, tcfg)
    got = quant.quantize_params(params_from_flax(
        fp, dataclasses.replace(tcfg, quantized_weights=False)))
    assert got.keys() == want.keys()
    assert got.keys() == Deepseek(tcfg, device="meta").state_dict().keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if w.dtype == torch.int8:
            assert torch.equal(g, w), k
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=0, err_msg=k)
    for k in ("layers.1.moe.routed.w_gate.weight",
              "layers.2.moe.shared.down.weight"):
        assert got[k].dtype == torch.int8, k
    for k in ("layers.1.moe.routed.router.weight",
              "layers.1.attn.kv_b_kernel"):
        assert got[k].dtype == torch.float32, k
    model = Deepseek(tcfg, device="cpu")
    model.load_state_dict(want)
    assert model.layers[1].moe.routed.mode == "einsum"
    tokens, seg = _batch(8)
    ref = np.asarray(jax.jit(JDeepseek(jcfg).apply)(
        {"params": jq}, jnp.asarray(tokens), segment_ids=jnp.asarray(seg))[0])
    with torch.no_grad():
        out = model(torch.from_numpy(tokens),
                    segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_quantize_model_covers_routed_and_shared_experts():
    """serve.quantize_model (tensor by tensor, freeing each weight) gives
    quantize_params' state dict: int8 routed stacks and shared MLP, fp
    routers; the int8 twin runs the einsum dispatch."""
    from tpufw_torch.models.mixtral import QuantExperts
    from tpufw_torch.models.llama import QuantProjection
    from tpufw_torch.workloads import serve

    _, tcfg = _pair("first_dense", moe_dispatch="sorted")
    model = _port(tcfg.decode_config(), _flax_params("first_dense"))
    want = quant.quantize_params(model.state_dict())
    qmodel = serve.quantize_model(model, release=True)
    got = qmodel.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    moe = qmodel.layers[1].moe
    assert isinstance(moe.routed.w_up, QuantExperts)
    assert isinstance(moe.shared.down, QuantProjection)
    assert moe.routed.router.weight.dtype == torch.float32
    assert moe.routed.mode == "einsum"


def test_train_workload_honours_moe_dispatch(clear_tpufw_env):
    """TPUFW_MODEL=deepseek_moe_tiny trains through the workload, its MoE
    layers on TPUFW_MOE_DISPATCH; the V2-Lite train slice resolves with
    its own trainer defaults."""
    from tpufw_torch.workloads import train_llama

    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    clear_tpufw_env.setenv("TPUFW_MODEL", "deepseek_moe_tiny")
    for mode in ("einsum", "sorted"):
        clear_tpufw_env.setenv("TPUFW_MOE_DISPATCH", mode)
        trainer, cfg = train_llama.build_trainer()
        assert cfg.moe_dispatch == mode
        model = trainer.init_state()
        assert {b.moe.routed.mode for b in model.layers} == {mode}
    clear_tpufw_env.setenv("TPUFW_MODEL", "deepseek_v2_lite_train_slice")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "meta")
    trainer, cfg = train_llama.build_trainer()
    assert cfg.n_layers == 3 and cfg.attention_backend == "flash"
    assert cfg.moe_dispatch == "sorted" and cfg.capacity_factor == 1.25
    assert (trainer.cfg.batch_size, trainer.cfg.seq_len) == (2, 2048)
    assert trainer.cfg.loss_chunk_size == 512


# ----------------------------------------------------------------------
# HF and the V2-Lite preset
# ----------------------------------------------------------------------

HF_MOE = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
    first_k_dense_replace=1, norm_topk_prob=False, routed_scaling_factor=1.0,
    topk_method="greedy", scoring_func="softmax", max_position_embeddings=128,
    rms_norm_eps=1e-6, tie_word_embeddings=False, attention_bias=False,
)


@functools.lru_cache(maxsize=None)
def _hf_moe():
    torch.manual_seed(1)
    return transformers.DeepseekV2ForCausalLM(
        transformers.DeepseekV2Config(**HF_MOE)).eval()


def test_hf_logits_match_transformers_and_tpufw():
    """An HF DeepseekV2 with routed experts imports dropless and
    unscanned, as tpufw imports it; the port's logits are transformers'
    and tpufw's, and its state dict is params_from_flax of tpufw's
    import, bit for bit."""
    hf = _hf_moe()
    cfg = dataclasses.replace(import_hf.config_from_hf(hf.config),
                              dtype=torch.float32, remat=False)
    jcfg = dataclasses.replace(j_import.config_from_hf(hf.config),
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               remat=False)
    for f in ("n_routed_experts", "experts_per_token", "moe_d_ff",
              "n_shared_experts", "first_k_dense", "capacity_factor",
              "norm_topk_prob", "scan_layers", "n_group", "topk_group"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.capacity_factor == 4.0 and not cfg.scan_layers
    sd = import_hf.from_hf(hf, cfg)
    model = Deepseek(cfg, device="cpu")
    model.load_state_dict(sd)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 24))
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.numpy()
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jparams = jax.device_get(j_import.from_hf(hf, jcfg))
    jgot = jax.jit(JDeepseek(jcfg).apply)(
        {"params": jparams}, jnp.asarray(tokens, jnp.int32))[0]
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
    bridged = params_from_flax(jparams, cfg)
    assert bridged.keys() == sd.keys()
    assert all(torch.equal(bridged[k], sd[k]) for k in sd)


def test_export_round_trip_with_moe_and_yarn(tmp_path):
    """tpufw's test_export_hf_roundtrip_moe_yarn on the port: a MoE + yarn
    model exports, transformers loads it with the same logits, the
    config.json is tpufw's export of the same config, and the port reads
    the directory back bit for bit."""
    yarn = dict(factor=16.0, original_max_position_embeddings=16,
                mscale=0.707, mscale_all_dim=0.707)
    jcfg, tcfg = _pair("first_dense", rope_scaling=JYarn(**yarn))
    tcfg = dataclasses.replace(tcfg, rope_scaling=YarnScaling(**yarn))
    params = jax.device_get(meta.unbox(jax.jit(JDeepseek(jcfg).init)(
        jax.random.key(12), jnp.zeros((1, 8), jnp.int32))["params"]))
    sd = params_from_flax(params, tcfg)
    model = Deepseek(tcfg, device="cpu")
    model.load_state_dict(sd)
    tokens = np.random.default_rng(11).integers(0, 256, (2, 24))
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).numpy()
    out = tmp_path / "hf"
    import_hf.export_hf(sd, tcfg, str(out))
    back = transformers.DeepseekV2ForCausalLM.from_pretrained(out).eval()
    with torch.no_grad():
        got = back(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    mine = json.loads((out / "config.json").read_text())
    theirs = j_import.hf_config_dict(jcfg)
    for k in ("n_routed_experts", "num_experts_per_tok",
              "moe_intermediate_size", "n_shared_experts",
              "first_k_dense_replace", "topk_method", "norm_topk_prob",
              "scoring_func", "moe_layer_freq", "rope_scaling"):
        assert mine[k] == theirs[k], k
    assert import_hf.config_from_hf(mine) == dataclasses.replace(
        tcfg, dtype=torch.bfloat16, remat=True)
    again = import_hf.from_hf(str(out), tcfg)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_v2_lite_preset_is_its_import():
    """DEEPSEEK_V2_LITE_HF through either package's config_from_hf gives
    the same config, 15,706,484,224 parameters; the slices are it cut as
    documented."""
    from tpufw_torch.configs import (
        deepseek_v2_lite,
        deepseek_v2_lite_serve_slice,
        deepseek_v2_lite_train_slice,
    )
    from tpufw_torch.configs.presets import DEEPSEEK_V2_LITE_HF

    cfg = deepseek_v2_lite()
    assert cfg == import_hf.config_from_hf(DEEPSEEK_V2_LITE_HF)
    jcfg = j_import.config_from_hf(DEEPSEEK_V2_LITE_HF)
    for f in dataclasses.fields(cfg):
        if f.name in ("dtype", "param_dtype", "rope_scaling"):
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(cfg.rope_scaling) == dataclasses.asdict(
        jcfg.rope_scaling)
    assert cfg.n_params() == jcfg.n_params() == 15_706_484_224
    assert (cfg.n_routed_experts, cfg.experts_per_token, cfg.moe_d_ff,
            cfg.n_shared_experts, cfg.first_k_dense) == (64, 6, 1408, 2, 1)
    assert cfg.capacity_factor == 64.0 and not cfg.scan_layers
    assert sum(p.numel() for p in Deepseek(cfg, device="meta").parameters()
               ) == cfg.n_params()
    train, tcfg = deepseek_v2_lite_train_slice()
    assert train.n_params() == 1_670_135_296 and train.qk_head_dim == 192
    assert dataclasses.replace(train, n_layers=27, attention_backend="xla",
                               capacity_factor=64.0) == cfg
    serve, prompts, max_new = deepseek_v2_lite_serve_slice()
    assert serve.decode and serve.param_dtype == torch.bfloat16
    assert serve.n_layers == 27 and serve.max_seq_len == 4096
    assert serve.rope_scaling == cfg.rope_scaling
    assert [len(p) for p in prompts] == [7, 64, 200, 511] and max_new == 32
