"""tpufw_torch SFT vs tpufw: the chat templates, assistant-only masks and
packed batches byte for byte, the tokenizer choice, 3 trainer steps on
the same conversations, and ``train_llama`` with ``TPUFW_SFT_DATA`` on
the CPU. Trainer losses are held to rtol 1e-4, as
``test_torch_trainer.py``'s trajectory test."""

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
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import sft as j_sft
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import Trainer, TrainerConfig
from tpufw_torch.train import sft

CONV = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "hi"},
    {"role": "assistant", "content": "hello"},
    {"role": "user", "content": "bye"},
    {"role": "assistant", "content": "ciao ☃"},
]


def _conversations(path, n=7):
    rows = []
    for i in range(n):
        turns = [{"role": "user", "content": f"question {i} " * (i % 3 + 1)},
                 {"role": "assistant", "content": f"answer {i}" * (i % 2 + 1)}]
        if i % 3 == 0:
            turns = [{"role": "system", "content": "terse"}] + turns + turns
        # Both line shapes, and one conversation with nothing to train.
        rows.append({"messages": turns} if i % 2 else turns)
    rows.append([{"role": "user", "content": "no reply"}])
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


@pytest.mark.parametrize("template", ["llama3", "chatml", "plain"])
def test_render_and_encode_equal_tpufw(template):
    assert sft.render_conversation(CONV, template) == \
        j_sft.render_conversation(CONV, template)
    for a, b in zip(sft.encode_conversation(CONV, sft.byte_encode, template),
                    j_sft.encode_conversation(CONV, j_sft.byte_encode,
                                              template)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("template", ["llama3", "chatml", "plain"])
def test_sft_batches_byte_equal_tpufw(tmp_path, template):
    """Shuffled, sharded and packed over two epochs: every array of every
    batch equal, dtype included."""
    path = _conversations(tmp_path / "c.jsonl")
    for shard in (0, 1):
        kw = dict(batch_size=3, seq_len=40, template=template, epochs=2,
                  seed=5, shard_id=shard, num_shards=2)
        got = list(sft.sft_batches(path, encode=sft.byte_encode, **kw))
        want = list(j_sft.sft_batches(path, encode=j_sft.byte_encode, **kw))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_conversation_guards(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text(json.dumps({"conversations": [{"from": "human"}]}))
    with pytest.raises(ValueError, match="expected a message list"):
        list(sft.read_conversations(p))
    p.write_text(json.dumps([{"role": "user", "content": "hi"}]))
    with pytest.raises(ValueError, match="no conversation has an"):
        next(sft.sft_batches(p, 1, 16, sft.byte_encode))
    with pytest.raises(ValueError, match="unknown chat template"):
        sft.render_conversation(CONV, "alpaca")


def test_resolve_encode_takes_bytes_or_a_local_directory(tmp_path):
    from tpufw_torch.workloads._common import resolve_encode

    assert resolve_encode("bytes")("a☃") == j_sft.byte_encode("a☃")
    with pytest.raises(FileNotFoundError, match="no hub download"):
        resolve_encode("meta-llama/Meta-Llama-3-8B")


def test_sft_trainer_losses_match_tpufw(tmp_path, devices8):
    """The same conversations through each package's sft_batches and
    trainer, from the same weights: 3 losses within rtol 1e-4."""
    path = _conversations(tmp_path / "c.jsonl")
    jcfg = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                               dtype=torch.float32)
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=1e-2,
              warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32")
    data = dict(batch_size=8, seq_len=33, template="llama3", seed=2)
    jt = JTrainer(JLlama(jcfg), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(jt.state.params)
    j_hist = jt.run(j_sft.sft_batches(path, encode=j_sft.byte_encode, **data),
                    model_flops_per_token=jcfg.flops_per_token(32))
    tt = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    tt.init_state(state_dict=params_from_flax(params, tcfg))
    t_hist = tt.run(sft.sft_batches(path, encode=sft.byte_encode, **data),
                    model_flops_per_token=tcfg.flops_per_token(32))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose([m.loss for m in t_hist],
                               [m.loss for m in j_hist], rtol=1e-4)


ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="2",
       SEQ_LEN="33", LOSS_CHUNK_SIZE="8", TOTAL_STEPS="2",
       WARMUP_STEPS="1", HANDLE_PREEMPTION="0")


def _env(monkeypatch, **env):
    workload_env(monkeypatch, ENV, **env)


def test_train_llama_sft_data_trains(tmp_path, monkeypatch, capsys):
    """TPUFW_SFT_DATA trains (it raised NotImplementedError before the
    port had the objective): one JSON line a step, then TRAIN OK."""
    from tpufw_torch.workloads import train_llama

    path = _conversations(tmp_path / "c.jsonl")
    _env(monkeypatch, SFT_DATA=path, SFT_TEMPLATE="chatml")
    assert train_llama.main() == 0
    out = capsys.readouterr().out
    steps = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"step"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)
    assert "TRAIN OK: 2 steps" in out
