"""tpufw_torch GRPO vs tpufw: the per-token chunked log-probs and the
group advantages at 2e-4 (``tests/conftest.py``'s tolerance),
``grpo_train_step`` over 2 updates on one fixed rollout batch with
``tpufw``'s loss, ratio, clip share and KL at rtol 1e-4, then the port's
own contracts: the ratio anchor (mean ratio 1, no clip, KL 0 on the first
update of each step), the rollout's rows, the decode view on the policy's
tensors, LoRA training adapters alone against the bypassed base, a
resumed ``run_rl`` equal to an uninterrupted one (per-step sampling
streams), the guards, and ``python -m tpufw_torch.workloads.rl`` on the
CPU. Sampled tokens cannot equal JAX's (threefry against Philox)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufw.mesh import MeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.ops import loss as j_loss
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import grpo as j_grpo
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.models.lora import is_lora_name
from tpufw_torch.ops import loss
from tpufw_torch.train import TrainerConfig
from tpufw_torch.train import grpo

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = [[7, 8, 9], [10, 11]]


def low_token(prompts, completions):
    """The share of completion ids below 128."""
    return np.array([np.mean([t < 128 for t in c]) if c else 0.0
                     for c in completions])


def _cfg(lora_rank=0):
    return dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                               dtype=torch.float32, lora_rank=lora_rank)


def _trainer(lora_rank=0, kl_beta=0.0, steps=3, ckpt=None, **grpo_kw):
    tcfg = TrainerConfig(batch_size=8, seq_len=24, total_steps=steps,
                         lr=1e-2, warmup_steps=1, loss_chunk_size=8,
                         checkpoint_dir=ckpt, checkpoint_every=1,
                         handle_preemption=False)
    conf = dict(group_size=4, max_new_tokens=8, kl_beta=kl_beta,
                ref_dtype="float32") | grpo_kw
    return grpo.GRPOTrainer(_cfg(lora_rank), tcfg, device="cpu",
                            grpo=grpo.GRPOConfig(**conf))


@pytest.mark.parametrize("cap, scale, dtype", [
    (None, 1.0, "float32"), (3.0, 1 / 0.7, "float32"),
    (None, 1 / 0.7, "bfloat16")])
def test_chunked_token_logprob_matches_tpufw(cap, scale, dtype):
    rng = np.random.default_rng(0)
    b, t, d, v = 3, 29, 16, 50
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    kernel = rng.standard_normal((d, v)).astype(np.float32) * 0.5
    targets = rng.integers(0, v, (b, t))
    kw = dict(chunk_size=8, logits_soft_cap=cap, logits_scale=scale)
    got = loss.chunked_token_logprob(
        torch.as_tensor(hidden), torch.as_tensor(kernel),
        torch.as_tensor(targets), compute_dtype=getattr(torch, dtype), **kw)
    want = j_loss.chunked_token_logprob(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(targets),
        compute_dtype=jnp.dtype(dtype), **kw)
    assert got.shape == (b, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_group_advantages_match_tpufw():
    r = np.random.default_rng(2).random(12).astype(np.float32)
    r[4:8] = 0.5  # a group of equal rewards: advantage 0
    np.testing.assert_allclose(grpo.group_advantages(r, 4),
                               j_grpo.group_advantages(r, 4), **TOL)
    assert not grpo.group_advantages(r, 4)[4:8].any()
    with pytest.raises(ValueError, match="groups of"):
        grpo.group_advantages(r[:10], 4)


def test_grpo_train_step_matches_tpufw(devices8):
    """One fixed rollout batch (old log-probs scored by tpufw's policy),
    2 updates with the k3 KL against an fp32 reference: loss, mean ratio,
    clip share and KL equal tpufw's; the second update clips."""
    jcfg = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32)
    kw = dict(batch_size=8, seq_len=24, total_steps=2, lr=5e-2,
              warmup_steps=0, loss_chunk_size=8, loss_chunk_dtype="float32")
    conf = dict(group_size=4, kl_beta=0.1, temperature=0.8,
                ref_dtype="float32")
    jt = j_grpo.GRPOTrainer(JLlama(jcfg), JTrainerConfig(**kw),
                            MeshConfig(data=8), grpo=j_grpo.GRPOConfig(**conf))
    jt.init_state(seed=0)
    tt = grpo.GRPOTrainer(_cfg(), TrainerConfig(**kw), device="cpu",
                          grpo=grpo.GRPOConfig(**conf))
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(jt.state.params), tt.model_cfg))
    rng = np.random.default_rng(3)
    tokens = np.zeros((8, 24), np.int32)
    mask = np.zeros((8, 24), np.float32)
    seg = np.zeros((8, 24), np.int32)
    for i in range(8):
        p, n = 3 + i % 3, 24 - 2 * (i % 4)
        tokens[i, :n] = rng.integers(1, 256, n)
        seg[i, :n] = 1
        mask[i, p:n] = 1.0
    batch = {"tokens": tokens, "loss_mask": mask, "segment_ids": seg,
             "old_logp": np.array(jt._score(tokens, seg), np.float32),
             "advantages": grpo.group_advantages(rng.random(8), 4)}
    step = jt.compiled_step(batch)
    clips = []
    for _ in range(2):
        jt.state, jm = step(jt.state, batch)
        tm = tt.train_step(batch)
        for k in ("loss", "mean_ratio", "clip_frac", "kl"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        clips.append(float(tm["clip_frac"]))
    assert clips[1] > 0


def test_ratio_anchor_and_lora_adapters_only():
    """Every step's update starts at the rollout policy: mean ratio 1 and
    no clip (the rollout's scoring and the update compute the same
    log-probs); the KL to the bypassed base is 0 until the adapters move;
    only adapters train."""
    tr = _trainer(lora_rank=4, kl_beta=0.05)
    model = tr.init_state(seed=0)
    assert tr.ref_model is None and tr.has_reference()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hist = tr.run_rl(PROMPTS, low_token, seed=1)
    assert [h["step"] for h in hist] == [1, 2, 3]
    for h in hist:
        assert abs(h["mean_ratio"] - 1.0) <= 1e-6 and h["clip_frac"] == 0.0
    assert hist[0]["kl"] == 0.0 and hist[2]["kl"] > 0.0
    after = model.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all(is_lora_name(k) for k in moved)


def test_rollout_rows_and_eos(monkeypatch):
    """Training rows are right-padded with the prompt at position 0, the
    mask on the completion only; a completion ends after its first EOS;
    old_logp is the current policy's [N, T-1] score."""
    import tpufw_torch.infer as infer

    tr = _trainer(eos_id=5)
    tr.init_state(seed=0)
    fixed = torch.tensor([[1, 2, 5, 9, 9, 9, 9, 9]] * 4
                         + [[3, 3, 3, 3, 3, 3, 3, 3]] * 4)
    seen = {}

    def fake_generate(model, ptoks, pads, gen, **kw):
        seen.update(width=ptoks.shape[1], pads=list(pads), kw=kw)
        return fixed

    monkeypatch.setattr(infer, "generate", fake_generate)
    batch, info = tr.rollout(PROMPTS, low_token)
    # Left-padded to the fixed width seq_len - max_new for the decode.
    assert seen["width"] == 16 and seen["pads"] == [13] * 4 + [14] * 4
    assert seen["kw"]["eos_id"] == 5
    for i, p in enumerate([PROMPTS[0]] * 4 + [PROMPTS[1]] * 4):
        comp = [1, 2, 5] if i < 4 else [3] * 8
        row = p + comp
        assert batch["tokens"][i, :len(row)].tolist() == row
        assert not batch["tokens"][i, len(row):].any()
        assert batch["loss_mask"][i].tolist() == (
            [0.0] * len(p) + [1.0] * len(comp) + [0.0] * (24 - len(row)))
        assert batch["segment_ids"][i].sum() == len(row)
    assert info["completion_len_mean"] == 5.5
    want = tr._score(torch.as_tensor(batch["tokens"]),
                     torch.as_tensor(batch["segment_ids"]))
    assert batch["old_logp"].shape == (8, 23)
    assert torch.equal(batch["old_logp"], want)


def test_decode_view_is_the_policy():
    """The decode view holds the policy's tensors (no copy), so after
    updates its logits are the policy's; a restore rebuilds it."""
    tr = _trainer(steps=2)
    tr.init_state(seed=0)
    view = tr.decode_view()
    assert view.cfg.decode and view.cfg.max_seq_len == 24
    assert view.embed.data_ptr() == tr.model.embed.data_ptr()
    tr.run_rl(PROMPTS, low_token, seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                               (2, 16)))
    with torch.no_grad():
        assert torch.equal(tr.decode_view()(tokens), tr.model(tokens))
    tr.assign_model(tr.model.state_dict())
    assert tr.decode_view() is not view


def test_run_rl_resume_equals_uninterrupted(tmp_path):
    """2 steps, a checkpoint, a fresh trainer resumed for the last 2:
    the same rewards and losses as 4 uninterrupted steps, since step i
    samples from SeedSequence([seed, i])."""
    straight = _trainer(steps=4)
    straight.init_state(seed=0)
    want = straight.run_rl(PROMPTS, low_token, seed=7)
    ck = str(tmp_path / "ck")
    first = _trainer(steps=2, ckpt=ck)
    first.init_state(seed=0)
    got = first.run_rl(PROMPTS, low_token, seed=7)
    second = _trainer(steps=4, ckpt=ck)
    assert second.maybe_restore() and second.step == 2
    got += second.run_rl(PROMPTS, low_token, seed=7)
    assert [h["step"] for h in got] == [1, 2, 3, 4]
    for k in ("reward_mean", "loss", "grad_norm", "kl"):
        assert [h[k] for h in got] == [h[k] for h in want], k


def test_guards(tmp_path):
    with pytest.raises(ValueError, match="group_size"):
        grpo.GRPOTrainer(_cfg(), TrainerConfig(batch_size=6), device="cpu",
                         grpo=grpo.GRPOConfig(group_size=4))
    with pytest.raises(NotImplementedError, match="grad_accum"):
        grpo.GRPOTrainer(_cfg(), TrainerConfig(batch_size=8, grad_accum=2),
                         device="cpu")
    tr = _trainer(kl_beta=0.1)
    with pytest.raises(RuntimeError, match="before init_state"):
        tr.rollout(PROMPTS, low_token)
    with pytest.raises(RuntimeError, match="reference snapshot"):
        tr.train_step({})
    tr.init_state(seed=0)
    with pytest.raises(ValueError, match="rows"):
        tr.rollout(PROMPTS[:1], low_token)
    with pytest.raises(ValueError, match="exceeds seq_len"):
        tr.rollout([list(range(20))] * 2, low_token)
    ck = str(tmp_path / "ck")
    t1 = _trainer(kl_beta=0.1, steps=1, ckpt=ck)
    t1.init_state(seed=0)
    t1.run_rl(PROMPTS, low_token)
    with pytest.raises(RuntimeError, match="no KL reference"):
        _trainer(kl_beta=0.1, ckpt=ck).maybe_restore()


ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="8",
       SEQ_LEN="24", LOSS_CHUNK_SIZE="8", TOTAL_STEPS="2",
       GRPO_GROUP="4", GRPO_MAX_NEW="6")


def _env(monkeypatch, **env):
    workload_env(monkeypatch, ENV, **env)


def test_rl_workload_runs(tmp_path, monkeypatch, capsys):
    from tpufw_torch.workloads import rl

    p = tmp_path / "prompts.jsonl"
    p.write_text('{"prompt": "hi"}\n[3, 4, 5]\n{"prompt": "abc"}\n')
    _env(monkeypatch, PROMPTS_FILE=p, REWARD="length", EOS_ID="-1")
    assert rl.main() == 0
    out = capsys.readouterr().out
    steps = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"reward_mean"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(s["reward_mean"] == 1.0 for s in steps)  # full length
    assert abs(steps[0]["mean_ratio"] - 1.0) <= 1e-6
    assert "RL OK: 2 steps" in out
    assert rl.load_prompts(p, lambda s: [len(s)]) == [[2], [3, 4, 5], [3]]
    f = rl.resolve_reward("low_token", 256, 8)
    assert f(None, [[1, 200], []]).tolist() == [0.5, 0.0]
    with pytest.raises(ValueError, match="TPUFW_REWARD"):
        rl.resolve_reward("nope", 256, 8)
    # Outside a gang the mesh must fit one device (the Trainer's check),
    # TENSOR's as DATA's; more than one host is tpufw's refusal.
    _env(monkeypatch, MESH_DATA="2")
    with pytest.raises(ValueError, match="1 devices not divisible"):
        rl.build_trainer()
    _env(monkeypatch, MESH_TENSOR="2")
    with pytest.raises(ValueError, match=r"'tensor': 2}$"):
        rl.build_trainer()
    _env(monkeypatch, COORDINATOR="127.0.0.1:1", NUM_PROCESSES="2")
    with pytest.raises(NotImplementedError, match="single-process for now"):
        rl.main()
