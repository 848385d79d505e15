"""tpufw_torch DPO vs tpufw: preference batches byte for byte (both
truncation cases of ``_fit_pair``), the per-row chunked log-probs and the
loss at 2e-4 (``tests/conftest.py``'s tolerance), 3 trainer steps with
``tpufw``'s losses and metrics at rtol 1e-4, the LoRA reference (the
policy's base with the adapters bypassed, within 1e-6 of an fp32
snapshot), the guards, and ``train_llama`` with ``TPUFW_DPO_DATA``.
CPU, fp32, llama3_tiny; weights cross through ``params_from_flax``."""

import dataclasses
import json
import math

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
from tpufw.train import dpo as j_dpo
from tpufw.train.sft import byte_encode as j_byte_encode
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.models.lora import is_lora_name
from tpufw_torch.ops import loss
from tpufw_torch.train import TrainerConfig
from tpufw_torch.train import dpo
from tpufw_torch.train.sft import byte_encode
from tpufw_torch.train.trainer import frozen_copy, shift_and_mask

TOL = dict(rtol=2e-4, atol=2e-4)
METRICS = ("loss", "accuracy", "margin", "reward_chosen", "reward_rejected")


def _pairs_file(path, n=8):
    rows = [{"prompt": f"item {i} " * (i % 3 + 1),
             "chosen": "good answer" + "!" * i, "rejected": "bad"}
            for i in range(n)]
    rows[1]["prompt"] = [{"role": "system", "content": "sys"},
                         {"role": "user", "content": "a message list"}]
    # Both rows overflow (the shared head dropped) / only the chosen one.
    rows[2] = {"prompt": "x" * 100, "chosen": "ok", "rejected": "ko"}
    rows[3] = {"prompt": "p" * 30, "chosen": "c" * 12, "rejected": "r"}
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


def _pair(lora_rank=0):
    jcfg = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32,
                               lora_rank=lora_rank)
    tcfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                               dtype=torch.float32, lora_rank=lora_rank)
    return jcfg, tcfg


@pytest.mark.parametrize("template", ["llama3", "chatml", "plain"])
def test_dpo_batches_byte_equal_tpufw(tmp_path, template):
    path = _pairs_file(tmp_path / "p.jsonl")
    kw = dict(batch_pairs=3, seq_len=48, template=template, epochs=2,
              seed=4)
    got = list(dpo.dpo_batches(path, encode=byte_encode, **kw))
    want = list(j_dpo.dpo_batches(path, encode=j_byte_encode, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_fit_pair_cases_equal_tpufw():
    """Both rows overflowing, and only the chosen one: one shared left
    cut, the same prompt suffix; a response that cannot fit raises in
    both packages."""
    for pair in ({"prompt": "x" * 100, "chosen": "ok", "rejected": "ko"},
                 {"prompt": "p" * 40, "chosen": "c" * 12, "rejected": "r"}):
        enc = dpo.encode_pair(pair, byte_encode, "plain")
        got = dpo._fit_pair(*enc, 48)
        want = j_dpo._fit_pair(*j_dpo.encode_pair(pair, j_byte_encode,
                                                  "plain"), 48)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        (tc, mc, _), (tr, mr, _) = got
        first = int(np.argmax(mc))
        assert first == int(np.argmax(mr)) > 0
        np.testing.assert_array_equal(tc[:first], tr[:first])
    pair = {"prompt": "q", "chosen": "y" * 100, "rejected": "n"}
    for mod, enc in ((dpo, byte_encode), (j_dpo, j_byte_encode)):
        with pytest.raises(ValueError, match="does not fit"):
            mod._fit_pair(*mod.encode_pair(pair, enc, "plain"), 24)


@pytest.mark.parametrize("cap, dtype", [(None, "float32"), (3.0, "float32"),
                                        (None, "bfloat16")])
def test_chunked_sequence_logprob_matches_tpufw(cap, dtype):
    rng = np.random.default_rng(0)
    b, t, d, v = 4, 37, 16, 50
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    kernel = rng.standard_normal((d, v)).astype(np.float32) * 0.5
    targets = rng.integers(0, v, (b, t))
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    got = loss.chunked_sequence_logprob(
        torch.as_tensor(hidden), torch.as_tensor(kernel),
        torch.as_tensor(targets), torch.as_tensor(mask), chunk_size=8,
        compute_dtype=getattr(torch, dtype), logits_soft_cap=cap)
    want = j_loss.chunked_sequence_logprob(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(targets),
        jnp.asarray(mask), chunk_size=8, compute_dtype=jnp.dtype(dtype),
        logits_soft_cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_dpo_loss_from_logps_matches_tpufw(ls):
    rng = np.random.default_rng(1)
    pol = rng.standard_normal(8).astype(np.float32)
    ref = rng.standard_normal(8).astype(np.float32)
    ref[:2] = pol[:2] + [0.5, 0.5]  # an exact tie: accuracy 0.5 there
    got_l, got_m = dpo.dpo_loss_from_logps(torch.as_tensor(pol),
                                           torch.as_tensor(ref), 0.3, ls)
    want_l, want_m = j_dpo.dpo_loss_from_logps(jnp.asarray(pol),
                                               jnp.asarray(ref), 0.3, ls)
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), **TOL)


def test_dpo_trainer_matches_tpufw(tmp_path, devices8):
    """3 steps on the same batches from the same weights, ref_dtype
    float32 on both sides: every loss and metric at rtol 1e-4. Step 0 is
    the ln 2 anchor. With LoRA, ``tpufw`` snapshots the whole tree (B
    zero) and the port scores the bypassed base: the same reference (the
    rank-0 frozen copy is held to it in
    ``test_lora_reference_is_the_bypassed_base``)."""
    path = _pairs_file(tmp_path / "p.jsonl")
    jcfg, tcfg = _pair(4)
    kw = dict(batch_size=8, seq_len=48, total_steps=3, lr=5e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    conf = dict(beta=0.5, ref_dtype="float32")
    jt = j_dpo.DPOTrainer(JLlama(jcfg), JTrainerConfig(**kw),
                          MeshConfig(data=8), dpo=j_dpo.DPOConfig(**conf))
    jt.init_state(seed=0)
    tt = dpo.DPOTrainer(tcfg, TrainerConfig(**kw), device="cpu",
                        dpo=dpo.DPOConfig(**conf))
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(jt.state.params), tcfg))
    assert tt.ref_model is None
    batches = list(dpo.dpo_batches(path, 4, 48, byte_encode, epochs=1,
                                   seed=1))[:2] * 2
    step = jt.compiled_step(batches[0])
    for i, batch in enumerate(batches[:3]):
        jt.state, jm = step(jt.state, batch)
        tm = tt.train_step(batch)
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        if i == 0:
            assert float(tm["loss"]) == pytest.approx(math.log(2), abs=1e-6)
            assert float(tm["accuracy"]) == 0.5


def _lora_trainer(path, rank=4, steps=3, ckpt=None):
    _, tcfg = _pair(rank)
    tr = dpo.DPOTrainer(
        tcfg, TrainerConfig(batch_size=8, seq_len=48, total_steps=steps,
                            lr=5e-3, warmup_steps=1, loss_chunk_size=16,
                            checkpoint_dir=ckpt, checkpoint_every=1,
                            handle_preemption=False),
        device="cpu", dpo=dpo.DPOConfig(beta=0.5))
    return tr


def test_lora_reference_is_the_bypassed_base(tmp_path):
    """Step 0: the bypassed-adapter log-probs equal an fp32 snapshot's
    to 1e-6. After training the adapters (the base frozen), the
    reference is still the step-0 policy, bit for bit, and only the
    adapters moved."""
    path = _pairs_file(tmp_path / "p.jsonl")
    tr = _lora_trainer(path)
    model = tr.init_state(seed=0)
    batch = next(dpo.dpo_batches(path, 4, 48, byte_encode, seed=3))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    inputs, targets, seg, mask = shift_and_mask(b)

    def ref_logps(ref_model=None):
        with dpo.reference_policy(model, ref_model) as ref:
            return dpo.sequence_logps(ref, inputs, targets, seg, mask, 16,
                                      torch.float32)[0]

    step0 = ref_logps()
    snapshot = ref_logps(frozen_copy(model, torch.float32))
    np.testing.assert_allclose(step0.numpy(), snapshot.numpy(), rtol=0,
                               atol=1e-6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hist = tr.run(iter([batch] * 3), model_flops_per_token=1.0)
    assert [round(m.loss, 6) for m in hist][0] == round(math.log(2), 6)
    after = model.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all(is_lora_name(k) for k in moved)
    assert all(k in moved for k in after if k.endswith("_lora_b"))
    assert torch.equal(ref_logps(), step0)


def test_resume_keeps_the_reference(tmp_path):
    """A resumed LoRA run finds its reference in the checkpoint (the
    base); a resumed rank-0 run without a reference snapshot refuses,
    and one after init_state resumes."""
    path = _pairs_file(tmp_path / "p.jsonl")
    ck = str(tmp_path / "ck")
    first = _lora_trainer(path, steps=2, ckpt=ck)
    first.run(dpo.dpo_batches(path, 4, 48, byte_encode),
              model_flops_per_token=1.0)
    again = _lora_trainer(path, steps=3, ckpt=ck)
    assert again.maybe_restore() and again.step == 2 and again.has_reference()
    assert again.run(dpo.dpo_batches(path, 4, 48, byte_encode),
                     model_flops_per_token=1.0)[-1].step == 3

    ck0 = str(tmp_path / "ck0")
    _lora_trainer(path, rank=0, steps=2, ckpt=ck0).run(
        dpo.dpo_batches(path, 4, 48, byte_encode), model_flops_per_token=1.0)
    with pytest.raises(RuntimeError, match="without a reference"):
        _lora_trainer(path, rank=0, ckpt=ck0).maybe_restore()
    fresh = _lora_trainer(path, rank=0, ckpt=ck0)
    fresh.init_state(seed=0)
    assert fresh.maybe_restore() and fresh.ref_model is not None


def test_guards():
    _, tcfg = _pair()
    with pytest.raises(ValueError, match="ROW count"):
        dpo.DPOTrainer(tcfg, TrainerConfig(batch_size=7), device="cpu")
    with pytest.raises(NotImplementedError, match="grad_accum"):
        dpo.DPOTrainer(tcfg, TrainerConfig(batch_size=8, grad_accum=2),
                       device="cpu")
    tr = dpo.DPOTrainer(tcfg, TrainerConfig(batch_size=8, seq_len=33),
                        device="cpu")
    with pytest.raises(RuntimeError, match="reference snapshot"):
        tr.train_step({"tokens": np.zeros((8, 33), np.int32)})
    tr.init_state()
    with pytest.raises(ValueError, match="response mask"):
        tr.train_step({"tokens": np.zeros((8, 33), np.int32)})
    with pytest.raises(ValueError, match="no reference policy"):
        with dpo.reference_policy(tr.model):
            pass


ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="4",
       SEQ_LEN="48", LOSS_CHUNK_SIZE="16", TOTAL_STEPS="2",
       WARMUP_STEPS="1", HANDLE_PREEMPTION="0")


def _env(monkeypatch, **env):
    workload_env(monkeypatch, ENV, **env)


def test_train_llama_dpo_data_trains(tmp_path, monkeypatch, capsys):
    """TPUFW_DPO_DATA trains a DPOTrainer (step 1 at ln 2) with MFU on
    the 4/3 count; with TPUFW_DISTILL_TEACHER too it raises, as tpufw's
    build_trainer does."""
    from tpufw_torch.train.metrics import Meter
    from tpufw_torch.workloads import train_llama

    path = _pairs_file(tmp_path / "p.jsonl")
    _env(monkeypatch, DPO_DATA=path, DPO_BETA="0.2", LORA_RANK="4")
    trainer, cfg = train_llama.build_trainer()
    assert isinstance(trainer, dpo.DPOTrainer) and trainer.dpo.beta == 0.2
    counts = []
    init = Meter.__init__
    monkeypatch.setattr(Meter, "__init__", lambda self, *a, **k: (
        counts.append(k["flops_per_token"]), init(self, *a, **k))[1])
    assert train_llama.main() == 0
    assert counts == [pytest.approx(cfg.flops_per_token(47) * 4 / 3)]
    steps = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"step"')]
    assert len(steps) == 2
    assert steps[0]["loss"] == pytest.approx(math.log(2), abs=1e-6)
    _env(monkeypatch, DPO_DATA=path, DISTILL_TEACHER="llama3_tiny")
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_llama.build_trainer()
