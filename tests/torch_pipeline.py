"""Shared set-up of the port's pipeline parity tests: a tiny preset in both
packages in fp32, pipeline params made from a seed with numpy in
``tpufw``'s tree shapes, the same tokens through ``tpufw``'s schedules on
its 8 virtual devices (jitted) and through the port's on a
``LocalPipeGroup`` (every stage in one process), compared at the
reference's tolerance (tests/conftest.py: 2e-4)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.mesh import build_mesh as j_build_mesh
from tpufw.parallel import pipeline as jp
from tpufw_torch.interop import pipeline_params_from_jax
from tpufw_torch.parallel import pipeline as tp

TOL = dict(rtol=2e-4, atol=2e-4)
B, T, M = 16, 17, 4


def pair(jconfigs, tconfigs, name, **overrides):
    """(JAX config, port config) of preset ``name`` in fp32."""
    jcfg = dataclasses.replace(jconfigs[name], dtype=jnp.float32,
                               param_dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(tconfigs[name], dtype=torch.float32,
                               param_dtype=torch.float32, **overrides)
    return jcfg, tcfg


def llama_pair(name="llama3_tiny", **overrides):
    from tpufw.models import LLAMA_CONFIGS as J
    from tpufw_torch.models import LLAMA_CONFIGS as P

    return pair(J, P, name, **{"n_layers": 4, **overrides})


@functools.lru_cache(maxsize=None)
def j_mesh(**kw):
    return j_build_mesh(JMeshConfig(**kw))


def np_params(jcfg, n_stages: int, seed: int = 0) -> dict:
    """A pipeline tree of ``jcfg`` in ``tpufw``'s canonical shapes, numpy
    fp32 from ``seed``:
    kernels N(0, 1/fan-in), norms and biases 1 + 0.1 N or 0.1 N (not
    their init values, so a wrong read shows), the embedding N(0, 1) (a
    tied one at 1/sqrt(d))."""
    shapes = jax.eval_shape(
        lambda k: jp.init_pipeline_params(
            k, jcfg, jp.PipelineConfig(n_stages, 1)), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        x = rng.standard_normal(shape).astype(np.float32)
        if "norm" in name:
            # Gemma stores (1 + w) offsets (zero-init), the rest scales.
            return (0.1 * x + (0.0 if "pre_" in name or "post_" in name
                               or "gemma" in type(jcfg).__name__.lower()
                               else 1.0)).astype(np.float32)
        if name.endswith("['bq']") or name.endswith("['bk']") or \
                name.endswith("['bv']"):
            return 0.1 * x
        if name == "['embed']":
            return x / np.sqrt(shape[-1]) if "head" not in shapes else x
        fan_in = int(np.prod(shape[2:-1])) if len(shape) > 2 else shape[0]
        return x / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def virtual(params: dict, n_virtual: int, n_stages: int) -> dict:
    """Canonical numpy params regrouped into the interleaved layout."""
    out = dict(params)
    out["stages"] = jax.tree.map(
        lambda a: a.reshape(n_virtual, n_stages,
                            a.shape[0] * a.shape[1] // (n_virtual * n_stages),
                            *a.shape[2:]), params["stages"])
    return out


def tokens(seed: int, vocab: int, b: int = B, t: int = T) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def torch_params(params: dict) -> dict:
    return pipeline_params_from_jax(params)


def torch_batch(batch) -> dict:
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jitted(kind: str, jcfg, pipe, mesh):
    """One jitted ``tpufw`` entry a (config, pipeline, mesh): a test
    module compiles each once."""
    if kind == "forward":
        return jax.jit(lambda p, t, g: jp.pipeline_forward(
            p, t, jcfg, pipe, mesh, segment_ids=g))
    if kind == "gpipe":
        return jax.jit(jax.value_and_grad(
            lambda p, b: jp.pipeline_loss(p, b, jcfg, pipe, mesh)))
    from tpufw.parallel.pipeline_1f1b import pipeline_1f1b_value_and_grad

    return jax.jit(functools.partial(pipeline_1f1b_value_and_grad, cfg=jcfg,
                                     pipe=pipe, mesh=mesh))


def jax_forward(params, toks, jcfg, pipe, mesh, seg=None):
    """``tpufw``'s pipelined forward (logits, or (logits, aux)), jitted."""
    return _jitted("forward", jcfg, pipe, mesh)(params, toks, seg)


def jax_value_and_grad(params, batch, jcfg, pipe, mesh, schedule=None):
    """(loss, numpy grads) of ``tpufw``'s GPipe (or ``schedule``'s) step,
    jitted."""
    loss, grads = _jitted(schedule or "gpipe", jcfg, pipe, mesh)(params,
                                                                 batch)
    return float(loss), jax.device_get(grads)


def torch_value_and_grad(params, batch, tcfg, pipe, **kw):
    """(loss, numpy grads) of the port's step through ``pipe.schedule``'s
    own entry point on a ``LocalPipeGroup``."""
    from tpufw_torch.parallel.pipeline_1f1b import pipeline_1f1b_value_and_grad
    from tpufw_torch.parallel.pipeline_interleaved import (
        pipeline_interleaved_value_and_grad,
    )
    from tpufw_torch.parallel.pipeline_zb1 import pipeline_zb1_value_and_grad

    fn = {"gpipe": tp.gpipe_value_and_grad,
          "1f1b": pipeline_1f1b_value_and_grad,
          "zb1": pipeline_zb1_value_and_grad,
          "interleaved": pipeline_interleaved_value_and_grad}[pipe.schedule]
    loss, grads = fn(torch_params(params), torch_batch(batch), tcfg, pipe,
                     **kw)
    return float(loss), to_numpy(grads)


def assert_trees_close(got, want, **tol):
    """Every leaf of two nested dicts within ``tol`` (default TOL)."""
    tol = tol or TOL
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            try:
                assert_trees_close(got[k], want[k], **tol)
            except AssertionError as e:
                raise AssertionError(f"[{k}] {e}") from None
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def canonical(grads: dict, n_stages: int) -> dict:
    """Interleaved ``[v, S, lpc, ...]`` numpy grads as ``[S, lps, ...]``."""
    out = dict(grads)
    out["stages"] = jax.tree.map(
        lambda a: np.asarray(a).reshape(n_stages, -1, *a.shape[3:]),
        grads["stages"])
    return out
