"""Shared set-up of the tpufw_torch serving parity tests: one tiny preset
in both packages in fp32, the Flax weights moved into the port through
``params_from_flax``."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import meta

from tpufw.models.llama import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models.llama import LLAMA_CONFIGS, Llama

PRESETS = ("llama3_tiny", "mistral_tiny", "qwen25_tiny")


def pair(name, **overrides):
    """(JAX config, port config) of ``name`` in fp32."""
    jcfg = dataclasses.replace(
        J_CONFIGS[name], dtype=jnp.float32, param_dtype=jnp.float32,
        **overrides,
    )
    tcfg = dataclasses.replace(
        LLAMA_CONFIGS[name], dtype=torch.float32, param_dtype=torch.float32,
        **overrides,
    )
    return jcfg, tcfg


def flax_params(jcfg, seed=0):
    """Host (numpy) Flax params of ``jcfg``, initialized from ``seed``."""
    params = jax.jit(JLlama(jcfg).init)(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    return jax.device_get(meta.unbox(params))


def torch_model(tcfg, np_params):
    """The port's model of ``tcfg`` on the CPU, holding ``np_params``."""
    model = Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(np_params, tcfg))
    return model


@functools.lru_cache(maxsize=None)
def decode_pair(name="llama3_tiny", max_seq_len=None):
    """(JAX decode model, Flax params, port decode model holding them) of
    ``name`` in fp32, built once per process."""
    overrides = {} if max_seq_len is None else {"max_seq_len": max_seq_len}
    jcfg, tcfg = pair(name, **overrides)
    params = flax_params(jcfg)
    return (JLlama(jcfg.decode_config()), params,
            torch_model(tcfg.decode_config(), params))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models run one intra-op thread: many threads of several test
    workers on one host's cores spin against each other. Autouse in each
    test module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def workload_env(monkeypatch, base: dict, **env):
    """Only ``TPUFW_<k>`` = v of ``base`` updated by ``env`` in the
    environment: every other TPUFW_* variable removed."""
    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(f"TPUFW_{k}", str(v))
