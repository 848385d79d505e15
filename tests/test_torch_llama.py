"""tpufw_torch Llama vs the tpufw Flax Llama: the same Flax weights moved
through ``params_from_flax``, the same numpy-seeded tokens, fp32; logits
and every parameter gradient within 2e-4 (tests/conftest.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.models.llama import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models.llama import LLAMA_CONFIGS, Llama

TOL = dict(rtol=2e-4, atol=2e-4)
T = 48  # beyond mistral_tiny's 32-token window


def _pair(name, **overrides):
    jcfg = dataclasses.replace(J_CONFIGS[name], dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(LLAMA_CONFIGS[name], dtype=torch.float32,
                               **overrides)
    return jcfg, tcfg


def _flax_params(jcfg, tokens):
    params = JLlama(jcfg).init(jax.random.key(0), jnp.asarray(tokens))["params"]
    return jax.device_get(meta.unbox(params))


def _torch_model(tcfg, np_params):
    model = Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(np_params, tcfg))
    return model


def test_params_from_flax_names_and_shapes():
    """Every port parameter is filled, with its own shape, from the
    scanned Flax tree; the tied variant has no lm_head."""
    for tie in (False, True):
        jcfg, tcfg = _pair("qwen25_tiny", tie_embeddings=tie)
        tokens = np.zeros((1, 8), np.int32)
        sd = params_from_flax(_flax_params(jcfg, tokens), tcfg)
        model = Llama(tcfg, device="cpu")
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want
        assert ("lm_head" in sd) is (not tie)
        n = sum(int(np.prod(s)) for s in want.values())
        assert n == tcfg.n_params()


# (preset, config overrides, packed segments)
CASES = {
    "llama3_tiny": ("llama3_tiny", {}, False),
    "mistral_tiny": ("mistral_tiny", {}, False),
    "qwen25_tiny": ("qwen25_tiny", {}, False),
    "llama3_tiny_tied_remat_packed": (
        "llama3_tiny", {"tie_embeddings": True, "remat": True}, True,
    ),
}


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_grads_match_flax(case, backend):
    name, overrides, packed = CASES[case]
    jcfg, tcfg = _pair(name, **overrides)
    tcfg = dataclasses.replace(tcfg, attention_backend=backend)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, T)).astype(np.int32)
    seg = None
    if packed:
        seg = np.ones((2, T), np.int32)
        seg[:, 20:40] = 2
        seg[:, 40:] = 0
    r = rng.standard_normal((2, T, jcfg.vocab_size)).astype(np.float32)
    np_params = _flax_params(jcfg, tokens)

    model = JLlama(jcfg)

    def jloss(p):
        logits = model.apply(
            {"params": p}, jnp.asarray(tokens),
            segment_ids=None if seg is None else jnp.asarray(seg),
        )
        return (logits * r).sum(), logits

    (_, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params)
    )

    tmodel = _torch_model(tcfg, np_params)
    logits = tmodel(
        torch.tensor(tokens), segment_ids=None if seg is None else torch.tensor(seg)
    )
    (logits * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **TOL)
    want = params_from_flax(jax.device_get(j_grads), tcfg)
    for pname, p in tmodel.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[pname].numpy(), err_msg=pname, **TOL
        )


def test_unported_options_raise():
    for field, value in (("kv_page", 16),):
        cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], **{field: value})
        with pytest.raises(NotImplementedError, match=field):
            Llama(cfg, device="cpu")


def test_unknown_remat_policy_raises():
    """tpufw's ValueError for a remat_policy it does not know (the port
    has no env knob for it, as tpufw has none)."""
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], remat=True,
                              remat_policy="offload")
    with pytest.raises(ValueError, match="unknown remat_policy 'offload'"):
        Llama(cfg, device="cpu")
