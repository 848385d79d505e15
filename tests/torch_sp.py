"""Shared set-up of the port's sequence-parallel parity tests: the same
numpy-seeded inputs through ``tpufw``'s attention on its 8 virtual devices
and through the port's over a ``LocalSequenceGroup`` (every shard in one
process), outputs and per-argument gradients of ``sum(out²)`` compared at
the reference's 2e-4 (tests/conftest.py); and the sequence gangs' common
run: ``seq_len`` 65 (64 trained positions, two shards of 32) against
``tpufw``'s Trainer on ``MeshConfig(fsdp=4, sequence=2)``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

TOL = dict(rtol=2e-4, atol=2e-4)


def qkv(seed, b, t, h, kh, d, scale=1.0):
    """fp32 numpy q [B,T,H,D], k and v [B,T,K,D]; q and k times
    ``scale``."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((b, t, h, d)) * scale).astype(np.float32),
        (rng.standard_normal((b, t, kh, d)) * scale).astype(np.float32),
        rng.standard_normal((b, t, kh, d)).astype(np.float32),
    )


def segments(b, t, bounds):
    """[B, T] int32 segment ids: segment i + 1 over [bounds[i],
    bounds[i + 1]), the tail past the last bound padding (0)."""
    seg = np.zeros((b, t), np.int32)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, lo:hi] = i + 1
    return seg


def torch_run(fn, q, k, v, real=None):
    """(out, (dq, dk, dv)) of the port's ``fn`` on numpy inputs: the
    gradients of sum(out²) over the rows where ``real`` [B, T] is true
    (all rows when None), as numpy."""
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    kept = out if real is None else out * torch.from_numpy(
        real)[:, :, None, None]
    (kept ** 2).sum().backward()
    return out.detach().numpy(), tuple(t.grad.numpy() for t in ts)


def jax_run(fn, q, k, v, real=None):
    """``torch_run`` for a JAX ``fn``."""
    mask = None if real is None else jnp.asarray(real)[:, :, None, None]

    def loss(q, k, v):
        out = fn(q, k, v)
        kept = out if mask is None else jnp.where(mask, out, 0.0)
        return (kept ** 2).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), tuple(np.asarray(g) for g in grads)


def assert_runs_close(got, want, real=None, **tol):
    """Outputs (on the ``real`` rows) and each gradient within ``tol``
    (default ``TOL``)."""
    tol = tol or TOL
    out, grads = got
    out_w, grads_w = want
    if real is not None:
        out, out_w = out[real], out_w[real]
    np.testing.assert_allclose(out, out_w, **tol)
    for g, w, name in zip(grads, grads_w, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **tol)


# The sequence gangs: 3 steps of 8 rows of 65 tokens on sequence=2.
GANG_B, GANG_SEQ, GANG_STEPS = 8, 65, 3
GANG_KW = dict(batch_size=GANG_B, seq_len=GANG_SEQ, total_steps=GANG_STEPS,
               lr=1e-2, warmup_steps=1, loss_chunk_size=16,
               loss_chunk_dtype="float32")
SEQ2 = {"data": 1, "fsdp": 1, "sequence": 2}


def tpufw_sequence_trainer(jcls, jcfg, dpo=None):
    """``tpufw``'s Trainer (a ``DPOTrainer`` given ``dpo`` DPOConfig
    kwargs) of ``jcls(jcfg)`` on the ring backend over
    ``MeshConfig(fsdp=4, sequence=2)``, initialized from seed 0."""
    from tpufw.mesh import MeshConfig
    from tpufw.train import Trainer, TrainerConfig
    from tpufw.train import dpo as j_dpo

    args = (jcls(dataclasses.replace(jcfg, attention_backend="ring")),
            TrainerConfig(**GANG_KW), MeshConfig(fsdp=4, sequence=2))
    jt = (j_dpo.DPOTrainer(*args, dpo=j_dpo.DPOConfig(**dpo)) if dpo
          else Trainer(*args))
    jt.init_state(seed=0)
    return jt


def assert_gang_matches_tpufw(outs, losses, params):
    """Both ranks' losses equal, rank 0's within rtol 1e-4 of ``losses``
    and its gathered parameters within 2e-4 of ``params`` (the port's
    state dict of ``tpufw``'s final ones)."""
    assert outs[0]["losses"] == outs[1]["losses"]
    assert len(losses) == GANG_STEPS
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
    got = outs[0]["params"]
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)
