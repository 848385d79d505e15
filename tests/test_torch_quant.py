"""tpufw_torch.ops.quant vs tpufw.ops.quant, and the int8 Llama.

The port's ``quantize_params`` on a converted state dict gives the same
int8 codes as the JAX package's on the Flax tree, with scales within 1e-6
relative; a JAX int8 tree moved through ``params_from_flax`` gives logits
within 1e-4 of the JAX int8 model's (relative to their largest) and the
same greedy tokens; int8 stays within ``tests/test_quant.py``'s 5% of the
fp logits and matches at least half of fp's greedy tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import flax_params, pair, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import generate_text as j_generate_text
from tpufw.models.llama import Llama as JLlama
from tpufw.ops import quant as j_quant
from tpufw_torch.infer import generate_text
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import GEMMA_CONFIGS, Gemma, Llama
from tpufw_torch.ops import quant

PROMPTS = [[5, 17, 101, 7, 42, 9, 3], [200, 11], [77, 12, 200, 1]]


def _tokens(seed=1, shape=(2, 33)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _int8_pair(name):
    """(JAX int8 config, port int8 config, fp Flax params, JAX int8 tree)."""
    jcfg, tcfg = pair(name, quantized_weights=True)
    fp = flax_params(dataclasses.replace(jcfg, quantized_weights=False))
    # Eager, as the JAX serve path calls it: jitted, it rounds a few codes
    # that sit on a rounding boundary the other way.
    return jcfg, tcfg, fp, jax.device_get(j_quant.quantize_params(fp))


@pytest.mark.parametrize("name", ["llama3_tiny", "qwen25_tiny"])
def test_quantize_params_codes_equal_jax(name):
    _, tcfg, fp, jq = _int8_pair(name)
    want = params_from_flax(jq, tcfg)
    got = quant.quantize_params(params_from_flax(fp, tcfg))
    assert got.keys() == want.keys()
    model_keys = Llama(tcfg, device="cpu").state_dict().keys()
    assert got.keys() == model_keys
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if w.dtype == torch.int8:
            assert torch.equal(g, w), k
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kernel_matches_jax(dtype):
    """Codes equal for fp32 and bf16 weights (the scale is computed in the
    weight's dtype, then fp32, as in the JAX package); the round trip is
    within half a scale step."""
    w = np.random.default_rng(0).standard_normal((64, 4, 16)).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    want = j_quant.quantize_kernel(jw, (0,))
    got = quant.quantize_kernel(
        torch.tensor(np.asarray(jw.astype(jnp.float32))).to(
            getattr(torch, dtype)), (0,))
    assert torch.equal(got["q_kernel"],
                       torch.tensor(np.asarray(want["q_kernel"])))
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=1e-6, atol=0)
    back = got["q_kernel"].float() * got["scale"]
    err = (back - torch.tensor(np.asarray(jw.astype(jnp.float32)))).abs()
    assert (err <= got["scale"] / 2 + 1e-7).all()


def test_quantize_kv_matches_jax():
    kv = np.random.default_rng(2).standard_normal((2, 5, 2, 16)).astype(
        np.float32)
    jq, js = j_quant.quantize_kv(jnp.asarray(kv), n_feat=2)
    q, s = quant.quantize_kv(torch.tensor(kv), n_feat=2)
    assert torch.equal(q, torch.tensor(np.asarray(jq)))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        quant.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(j_quant.dequantize_kv(jq, js, jnp.float32)),
        rtol=1e-6, atol=1e-7,
    )


def test_quant_contract_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    q = rng.integers(-127, 128, (16, 8)).astype(np.int8)  # [in, out]
    s = rng.random(8).astype(np.float32)
    want = j_quant.quant_contract(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(s), 1)
    got = quant.quant_contract(torch.tensor(x), torch.tensor(q.T.copy()),
                               torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["llama3_tiny", "qwen25_tiny"])
def test_int8_logits_from_a_jax_int8_tree_match_jax(name):
    jcfg, tcfg, _, jq = _int8_pair(name)
    tokens = _tokens()
    want = np.asarray(jax.jit(JLlama(jcfg).apply)({"params": jq}, tokens))
    with torch.no_grad():
        got = torch_model(tcfg, jq)(torch.tensor(tokens)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_int8_greedy_decode_matches_jax():
    jcfg, tcfg, _, jq = _int8_pair("llama3_tiny")
    want = j_generate_text(JLlama(jcfg.decode_config()), jq, PROMPTS,
                           max_new_tokens=6)
    got = generate_text(torch_model(tcfg.decode_config(), jq), PROMPTS,
                        max_new_tokens=6)
    assert got == want


def _fp_and_int8_models():
    from tpufw_torch.workloads.serve import quantize_model

    _, tcfg = pair("llama3_tiny")
    fp = Llama(tcfg.decode_config(), device="cpu", seed=1)
    return fp, quantize_model(fp)


def test_int8_forward_close_to_fp():
    """tests/test_quant.py's rule: int8 logits within 5% of the fp
    logits' largest magnitude."""
    fp, q8 = _fp_and_int8_models()
    tokens = torch.tensor(_tokens(seed=4))
    with torch.no_grad():
        ref, out = fp(tokens), q8(tokens)
    assert (out - ref).abs().max() <= 0.05 * ref.abs().max()
    assert q8.layers[0].mlp.up.weight.dtype == torch.int8
    assert q8.lm_head.weight.dtype == torch.int8


def test_int8_greedy_mostly_matches_fp():
    fp, q8 = _fp_and_int8_models()
    prompts = _tokens(seed=5, shape=(2, 12)).tolist()
    ref = np.array(generate_text(fp, prompts, max_new_tokens=6))
    got = np.array(generate_text(q8, prompts, max_new_tokens=6))
    match = float((got == ref).mean())
    assert match >= 0.5, f"only {match:.0%} of greedy tokens match fp"


def test_quantize_params_needs_projections():
    with pytest.raises(ValueError, match="no projection weights"):
        quant.quantize_params({"embed": torch.zeros(4, 2)})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["llama3_tiny", "qwen25_tiny"])
def test_int8_under_bf16_activations_errs_as_jax(name, seed):
    """int8 weights served with bf16 activations, as TPUFW_QUANTIZE=int8
    with TPUFW_DECODE_DTYPE=bfloat16 serve them: the preset's bf16
    compute, the same Flax weights on both sides, quantized and then
    cast by each package's serving path. The port's int8-vs-bf16 logit
    error (relative to the bf16 logits' largest) equals the JAX
    package's within bf16 rounding, taken as 2^-6 of the largest logit:
    bf16 keeps 8 significant bits, and the two packages' bf16 logits of
    the same weights differ by up to 2.5 x 2^-8 here."""
    from tpufw.infer import cast_decode_params as j_cast
    from tpufw.models.llama import LLAMA_CONFIGS as J_CONFIGS
    from tpufw_torch.infer import cast_decode_params
    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.workloads.serve import quantize_model

    tol = 2.0 ** -6
    jcfg, tcfg = J_CONFIGS[name], LLAMA_CONFIGS[name]
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    fp = flax_params(pair(name)[0], seed=seed)
    tokens = _tokens(seed=seed + 1)
    j_bf16 = np.asarray(JLlama(jcfg).apply(
        {"params": j_cast(fp)}, tokens), np.float32)
    j_int8 = np.asarray(JLlama(dataclasses.replace(
        jcfg, quantized_weights=True)).apply(
        {"params": j_cast(j_quant.quantize_params(fp))}, tokens), np.float32)
    model = torch_model(tcfg, fp)
    q8 = cast_decode_params(quantize_model(model))
    bf16 = cast_decode_params(model)
    with torch.no_grad():
        t_bf16 = bf16(torch.tensor(tokens)).float().numpy()
        t_int8 = q8(torch.tensor(tokens)).float().numpy()

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    j_err, t_err = rel(j_int8, j_bf16), rel(t_int8, t_bf16)
    assert rel(t_bf16, j_bf16) <= tol and rel(t_int8, j_int8) <= tol
    assert abs(t_err - j_err) <= tol, (t_err, j_err)
    assert t_err <= 0.05


# ----------------------------------------------------------------------
# Gemma-2 (tests/test_quant.py's Gemma cases): projections to int8, the
# tied embedding stays fp.
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gemma_int8():
    """(JAX fp32 gemma2_tiny config, port config, fp Flax params, JAX int8
    tree)."""
    from flax.core import meta

    from tpufw.models.gemma import GEMMA_CONFIGS as J_GEMMA
    from tpufw.models.gemma import Gemma as JGemma

    jcfg = dataclasses.replace(J_GEMMA["gemma2_tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"],
                               dtype=torch.float32, param_dtype=torch.float32)
    fp = jax.jit(JGemma(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    fp = jax.device_get(meta.unbox(fp))
    return jcfg, tcfg, fp, jax.device_get(j_quant.quantize_params(fp))


def test_gemma_quantized_forward_close():
    """The port's int8 Gemma (``serve.quantize_model``) within 5% of the
    fp logits' largest magnitude, and its int8 codes equal JAX's."""
    from tpufw_torch.workloads.serve import quantize_model

    _, tcfg, fp, jq = _gemma_int8()
    model = Gemma(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(fp, tcfg))
    q8 = quantize_model(model)
    assert isinstance(q8, Gemma)
    qcfg = dataclasses.replace(tcfg, quantized_weights=True)
    want = params_from_flax(jq, qcfg)
    got = q8.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == torch.int8:
            assert torch.equal(got[k], w), k
    tokens = torch.tensor(_tokens(seed=2, shape=(1, 48)))
    with torch.no_grad():
        ref, out = model(tokens), q8(tokens)
    assert (out - ref).abs().max() <= 0.05 * ref.abs().max()


def test_gemma_int8_logits_match_jax():
    """A JAX int8 Gemma tree carried into the port gives JAX's int8
    logits."""
    from tpufw.models.gemma import Gemma as JGemma

    jcfg, tcfg, _, jq = _gemma_int8()
    qj = dataclasses.replace(jcfg, quantized_weights=True)
    qt = dataclasses.replace(tcfg, quantized_weights=True)
    tokens = _tokens(seed=3, shape=(2, 40))
    want = np.asarray(jax.jit(JGemma(qj).apply)({"params": jq}, tokens))
    model = Gemma(qt, device="cpu")
    model.load_state_dict(params_from_flax(jq, qt))
    with torch.no_grad():
        got = model(torch.tensor(tokens)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_gemma_tied_embeddings_stay_fp():
    """quantize_params on a Gemma state dict: every projection becomes
    int8 with a scale; the tied embedding and the norms stay fp32, and no
    lm_head appears."""
    _, tcfg, fp, _ = _gemma_int8()
    sd = params_from_flax(fp, tcfg)
    q = quant.quantize_params(sd)
    assert q["embed"].dtype == torch.float32 and q["embed"] is sd["embed"]
    assert not any(k.startswith("lm_head") for k in q)
    proj = [k for k in q if k.endswith(".weight") and "norm" not in k]
    assert len(proj) == 7 * tcfg.n_layers
    assert all(q[k].dtype == torch.int8 for k in proj)
    assert all(q[k].dtype == torch.float32 for k in q if "norm" in k)


# ----------------------------------------------------------------------
# Mixtral (tests/test_quant.py's Mixtral cases): the expert stacks to int8
# per (expert, out-channel), the router stays fp.
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mixtral_int8():
    """(JAX fp32 mixtral_tiny config, port config, fp Flax params, JAX
    int8 tree, eager as the JAX serve path quantizes)."""
    from flax.core import meta

    from tpufw.models.mixtral import MIXTRAL_CONFIGS as J_MIXTRAL
    from tpufw.models.mixtral import Mixtral as JMixtral
    from tpufw_torch.models import MIXTRAL_CONFIGS

    jcfg = dataclasses.replace(J_MIXTRAL["mixtral_tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(MIXTRAL_CONFIGS["mixtral_tiny"],
                               dtype=torch.float32, param_dtype=torch.float32)
    fp = jax.jit(JMixtral(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    fp = jax.device_get(meta.unbox(fp))
    return jcfg, tcfg, fp, jax.device_get(j_quant.quantize_params(fp))


def test_mixtral_expert_codes_and_scales_equal_jax():
    """quantize_params and serve.quantize_model on the converted Mixtral
    state dict: every int8 code (the expert stacks' transposed) equals
    tpufw's eager codes, scales within 1e-6, the router stays fp32, and
    the int8 model's logits equal tpufw's int8 Mixtral's and stay within
    5% of the fp logits."""
    from tpufw.models.mixtral import Mixtral as JMixtral
    from tpufw_torch.models import Mixtral
    from tpufw_torch.workloads.serve import quantize_model

    jcfg, tcfg, fp, jq = _mixtral_int8()
    qt = dataclasses.replace(tcfg, quantized_weights=True)
    want = params_from_flax(jq, qt)
    model = Mixtral(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(fp, tcfg))
    q8 = quantize_model(model)
    for got in (quant.quantize_params(model.state_dict()), q8.state_dict()):
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            if w.dtype == torch.int8:
                assert torch.equal(got[k], w), k
            else:
                np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                           rtol=1e-6, err_msg=k)
    moe = q8.layers[0].moe
    assert moe.w_down.weight.shape == (4, 64, 128)
    assert moe.w_down.scale.shape == (4, 64)
    assert moe.router.weight.dtype == torch.float32
    tokens = _tokens(seed=9, shape=(2, 17))
    qj = dataclasses.replace(jcfg, quantized_weights=True)
    j_int8 = np.asarray(JMixtral(qj).apply({"params": jq}, tokens)[0])
    with torch.no_grad():
        ref = model(torch.tensor(tokens)).numpy()
        out = q8(torch.tensor(tokens)).numpy()
    assert np.abs(out - j_int8).max() <= 1e-4 * np.abs(j_int8).max()
    assert np.abs(out - ref).max() <= 0.05 * np.abs(ref).max()


def test_quantize_model_release_frees_the_source():
    """quantize_model(release=True), the serving path's: the same codes
    as without release, and each quantized weight of the source freed."""
    from tpufw_torch.models import Mixtral
    from tpufw_torch.workloads.serve import quantize_model

    _, tcfg, fp, _ = _mixtral_int8()
    sd = params_from_flax(fp, tcfg)
    keep = Mixtral(tcfg, device="cpu")
    keep.load_state_dict(sd)
    drop = Mixtral(tcfg, device="cpu")
    drop.load_state_dict(sd)
    want = quantize_model(keep).state_dict()
    got = quantize_model(drop, release=True).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert drop.layers[0].moe.w_up.numel() == 0
    assert drop.lm_head.numel() == 0
    assert drop.layers[0].attn.q.weight.numel() == 0
    assert drop.embed.numel() > 0


def test_serve_mixtral_int8(clear_tpufw_env):
    """TPUFW_MODEL=mixtral_tiny TPUFW_QUANTIZE=int8: build_generator
    serves a Mixtral with int8 expert stacks, through run_batch."""
    from tpufw_torch.models import Mixtral
    from tpufw_torch.workloads import serve

    clear_tpufw_env.setenv("TPUFW_MODEL", "mixtral_tiny")
    clear_tpufw_env.setenv("TPUFW_QUANTIZE", "int8")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    model, cfg, restored = serve.build_generator()
    assert isinstance(model, Mixtral) and cfg.quantized_weights
    assert model.layers[0].moe.w_gate.weight.dtype == torch.int8
    out = serve.run_batch([[3, 4], [7, 8, 9]], max_new_tokens=3)
    assert [len(r["output"]) for r in out] == [3, 3]
