"""tpufw_torch contrastive embeddings vs tpufw: retrieval batches byte for
byte, ``pool_embeddings`` and ``info_nce_loss`` at 2e-4
(``tests/conftest.py``'s tolerance), 3 ``EmbeddingTrainer`` steps of both
published recipes (E5-Mistral: causal, last-token pooling; LLM2Vec:
``causal=False``, mean pooling) with ``tpufw``'s losses and metrics at
rtol 1e-4, LoRA training adapters alone, ``embed`` and
``evaluate_retrieval``, the guards, and ``python -m
tpufw_torch.workloads.embed`` on the CPU. CPU, fp32; weights cross
through ``params_from_flax``."""

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
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import contrastive as j_con
from tpufw.train.sft import byte_encode as j_byte_encode
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS, model_for_config
from tpufw_torch.models.lora import is_lora_name
from tpufw_torch.train import TrainerConfig
from tpufw_torch.train import contrastive as con
from tpufw_torch.train.sft import byte_encode

TOL = dict(rtol=2e-4, atol=2e-4)
METRICS = ("loss", "accuracy", "sim_pos", "sim_neg")
# recipe: (preset, causal, pooling, temperature).
RECIPES = {"e5_mistral": ("mistral_tiny", True, "last", 0.02),
           "llm2vec": ("llama3_tiny", False, "mean", 0.05)}


def _pairs_file(path, n=9):
    rows = [{"query": f"what is topic {i}" + "?" * (i % 4),
             "positive": f"topic {i} is item number {i} " * (1 + i % 3)}
            for i in range(n)]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


def _cfgs(recipe, **kw):
    name, causal, _, _ = RECIPES[recipe]
    window = {} if causal else {"sliding_window": None}
    jc = dataclasses.replace(J_CONFIGS[name], dtype=jnp.float32,
                             causal=causal, **window, **kw)
    tc = dataclasses.replace(LLAMA_CONFIGS[name], dtype=torch.float32,
                             causal=causal, **window, **kw)
    return jc, tc


def _conf(recipe):
    _, _, pooling, temp = RECIPES[recipe]
    return dict(pooling=pooling, temperature=temp)


def test_pair_batches_byte_equal_tpufw(tmp_path):
    path = _pairs_file(tmp_path / "p.jsonl")
    for shard in (0, 1):
        kw = dict(batch_pairs=2, seq_len=24, epochs=2, seed=3,
                  shard_id=shard, num_shards=2)
        got = list(con.pair_batches(path, encode=byte_encode, **kw))
        want = list(j_con.pair_batches(path, encode=j_byte_encode, **kw))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="< batch_pairs"):
        next(con.pair_batches(path, 8, 24, byte_encode, num_shards=2))


@pytest.mark.parametrize("mode", ["mean", "last"])
def test_pool_embeddings_match_tpufw(mode):
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((4, 10, 6)).astype(np.float32)
    seg = np.zeros((4, 10), np.int32)
    for i, n in enumerate((10, 3, 1, 0)):
        seg[i, :n] = 1
    got = con.pool_embeddings(torch.as_tensor(hidden), torch.as_tensor(seg),
                              mode)
    want = j_con.pool_embeddings(jnp.asarray(hidden), jnp.asarray(seg), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="unknown pooling"):
        con.pool_embeddings(torch.as_tensor(hidden), torch.as_tensor(seg),
                            "max")


@pytest.mark.parametrize("temp", [0.02, 0.5])
def test_info_nce_loss_matches_tpufw(temp):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((6, 12)).astype(np.float32)
    d = (q + 0.7 * rng.standard_normal((6, 12))).astype(np.float32)
    got_l, got_m = con.info_nce_loss(torch.as_tensor(q), torch.as_tensor(d),
                                     temp)
    want_l, want_m = j_con.info_nce_loss(jnp.asarray(q), jnp.asarray(d), temp)
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), **TOL)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_embedding_trainer_matches_tpufw(tmp_path, devices8, recipe):
    path = _pairs_file(tmp_path / "p.jsonl")
    jc, tc = _cfgs(recipe)
    kw = dict(batch_size=8, seq_len=24, total_steps=3, lr=5e-3,
              warmup_steps=1)
    jt = j_con.EmbeddingTrainer(
        JLlama(jc), JTrainerConfig(**kw), MeshConfig(data=8),
        contrastive=j_con.ContrastiveConfig(**_conf(recipe)))
    jt.init_state(seed=0)
    tt = con.EmbeddingTrainer(tc, TrainerConfig(**kw), device="cpu",
                              contrastive=con.ContrastiveConfig(
                                  **_conf(recipe)))
    tt.init_state(state_dict=params_from_flax(jax.device_get(jt.state.params),
                                              tc))
    batches = list(con.pair_batches(path, 4, 24, byte_encode, seed=2,
                                    epochs=2))[:3]
    step = jt.compiled_step(batches[0])
    for batch in batches:
        jt.state, jm = step(jt.state, batch)
        tm = tt.train_step(batch)
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    probe = batches[0]
    np.testing.assert_allclose(
        tt.embed(probe["tokens"], probe["segment_ids"]),
        jt.embed(probe["tokens"], probe["segment_ids"]), **TOL)


def test_lora_llm2vec_trains_adapters_and_embeds(tmp_path):
    """Bidirectional LoRA: only adapters move; embed() gives unit-norm
    [N, D] fp32 vectors; evaluate_retrieval scores the whole pool."""
    path = _pairs_file(tmp_path / "p.jsonl")
    _, tc = _cfgs("llm2vec", lora_rank=4)
    tr = con.EmbeddingTrainer(
        tc, TrainerConfig(batch_size=8, seq_len=24, total_steps=3, lr=5e-3,
                          warmup_steps=1, handle_preemption=False),
        device="cpu", contrastive=con.ContrastiveConfig(**_conf("llm2vec")))
    model = tr.init_state(seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hist = tr.run(con.pair_batches(path, 4, 24, byte_encode),
                  model_flops_per_token=1.0)
    assert len(hist) == 3 and all(np.isfinite(m.loss) for m in hist)
    after = model.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all(is_lora_name(k) for k in moved)
    toks, seg = con._fit(byte_encode("a query"), 24)
    emb = tr.embed(np.stack([toks, toks]), np.stack([seg, seg]))
    assert emb.shape == (2, tc.d_model) and emb.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)
    ev = tr.evaluate_retrieval(path, byte_encode, batch_rows=5)
    assert ev["n"] == 9 and 0.0 < ev["mrr"] <= 1.0
    assert set(ev) == {"recall@1", "recall@5", "recall@10", "mrr", "n"}


def test_guards():
    _, tc = _cfgs("llm2vec")
    with pytest.raises(ValueError, match="ROW count"):
        con.EmbeddingTrainer(tc, TrainerConfig(batch_size=7), device="cpu")
    with pytest.raises(NotImplementedError, match="grad_accum"):
        con.EmbeddingTrainer(tc, TrainerConfig(batch_size=8, grad_accum=2),
                             device="cpu")
    with pytest.raises(ValueError, match="unknown pooling"):
        con.EmbeddingTrainer(tc, TrainerConfig(batch_size=8), device="cpu",
                             contrastive=con.ContrastiveConfig(pooling="max"))
    tr = con.EmbeddingTrainer(tc, TrainerConfig(batch_size=8), device="cpu")
    with pytest.raises(NotImplementedError, match="evaluate_retrieval"):
        tr.evaluate(iter([]))
    with pytest.raises(RuntimeError, match="before init_state"):
        tr.embed(np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32))
    tokens = torch.zeros(1, 16, dtype=torch.long)
    windowed = model_for_config(dataclasses.replace(tc, sliding_window=8),
                                device="cpu")
    with pytest.raises(ValueError, match="causal-relative"):
        windowed(tokens)
    dec = model_for_config(tc.decode_config(), device="cpu")
    with pytest.raises(ValueError, match="KV cache"):
        dec(tokens, cache=dec.init_cache(1))


def test_embed_workload_runs(tmp_path, monkeypatch, capsys):
    """LLM2Vec on mistral_tiny (TPUFW_BIDIRECTIONAL drops the window):
    steps, the retrieval probe, EMBED OK; MFU counts the trunk without
    the head and the bidirectional scores in full, tpufw's count."""
    from tpufw_torch.train.metrics import Meter
    from tpufw_torch.workloads import embed

    path = _pairs_file(tmp_path / "p.jsonl")
    workload_env(monkeypatch, dict(
        DEVICE="cpu", MODEL="mistral_tiny", BATCH_SIZE="8", SEQ_LEN="24",
        TOTAL_STEPS="2", WARMUP_STEPS="1", EMBED_DATA=path,
        BIDIRECTIONAL="1", POOLING="mean"))
    counts = []
    init = Meter.__init__
    monkeypatch.setattr(Meter, "__init__", lambda self, *a, **k: (
        counts.append(k["flops_per_token"]), init(self, *a, **k))[1])
    assert embed.main() == 0
    jc = dataclasses.replace(J_CONFIGS["mistral_tiny"], causal=False,
                             sliding_window=None)
    assert counts == [pytest.approx(
        jc.flops_per_token(23) - 6.0 * jc.d_model * jc.vocab_size
        + jc._attn_score_flops(23))]
    out = capsys.readouterr().out
    assert "causal=False" in out and "EMBED OK: 2 steps" in out
    probe = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"probe_sim_matched"')]
    assert len(probe) == 1
    monkeypatch.delenv("TPUFW_EMBED_DATA")
    with pytest.raises(ValueError, match="TPUFW_EMBED_DATA"):
        embed.main()
