"""tpufw_torch.workloads.serve, batch mode, against tpufw.workloads.serve:
sampling and EOS resolution from the environment, the batch helpers and
the byte codec give the JAX workload's values; ``run_batch`` and ``main``
serve the tiny model on the CPU in fp and int8; the weight knobs load
bare params, training checkpoints and a local tokenizer directory; the
knobs that are not ported raise, the ported speculation and
chunked-prefill knobs give
tpufw's greedy tokens, and the server does not fall back to the CPU. The HTTP
server itself is in test_torch_http.py and test_torch_serve_metrics.py."""

import json

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.tools.pack_corpus import byte_tokenizer
from tpufw.workloads import serve as j_serve
from tpufw_torch.infer import generate_text
from tpufw_torch.workloads import serve

PROMPTS = [[1, 42, 7, 99], [1, 5], [1, 100, 200, 30, 17]]


@pytest.fixture
def cpu_env(clear_tpufw_env):
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    clear_tpufw_env.setenv("TPUFW_MODEL", "llama3_tiny")
    return clear_tpufw_env


SAMPLING_ENVS = {
    "defaults": {},
    "knobs": {"TEMPERATURE": "0.7", "TOP_K": "40", "MIN_P": "0.05",
              "REPETITION_PENALTY": "1.2"},
    "quantized_floats": {"TEMPERATURE": "0.3333", "TOP_P": "0.91234"},
    "disabled": {"TOP_P": "1.0", "REPETITION_PENALTY": "1", "TOP_K": "0"},
}


@pytest.mark.parametrize("case", sorted(SAMPLING_ENVS))
def test_sampling_env_matches_jax(clear_tpufw_env, case):
    for k, v in SAMPLING_ENVS[case].items():
        clear_tpufw_env.setenv(f"TPUFW_{k}", v)
    assert vars(serve.sampling_from_env()) == vars(j_serve.sampling_from_env())


def test_sampling_env_defaults_greedy(clear_tpufw_env):
    s = serve.sampling_from_env()
    assert s.temperature == 0.0
    assert s.top_k is None and s.top_p is None and s.min_p is None
    assert s.repetition_penalty is None


@pytest.mark.parametrize(
    "bad", [{"temperature": -1}, {"top_k": 1.5}, {"top_k": -2},
            {"top_p": 0}, {"min_p": 2}, {"repetition_penalty": 0}],
)
def test_make_sampling_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        j_serve.make_sampling(**bad)
    with pytest.raises(ValueError):
        serve.make_sampling(**bad)


@pytest.mark.parametrize("value", [None, "-1", "0", "7"])
def test_eos_env_matches_jax(clear_tpufw_env, value):
    if value is not None:
        clear_tpufw_env.setenv("TPUFW_EOS_ID", value)
    assert serve.eos_from_env() == j_serve.eos_from_env()


def test_batch_helpers_match_jax():
    for n in (1, 2, 3, 5, 64, 65):
        assert serve._pow2_ceil(n) == j_serve._pow2_ceil(n)
        assert serve._pad_batch(PROMPTS[:1] * n, 9) == j_serve._pad_batch(
            PROMPTS[:1] * n, 9)
    for need, cap in ((100, 8192), (129, 8192), (257, 8192), (9000, 8192),
                      (1, 64)):
        assert serve._cache_bucket(need, cap) == j_serve._cache_bucket(
            need, cap)
    assert serve._cache_bucket(129, 8192) == 256


def test_text_codec_bytes(clear_tpufw_env):
    encode, decode = serve.text_codec()
    text = "héllo, wörld"
    assert encode(text) == byte_tokenizer(text)
    assert decode(encode(text)) == text
    # Any other value is a local tokenizer directory; a hub name is not
    # fetched.
    clear_tpufw_env.setenv("TPUFW_TOKENIZER", "gpt2")
    with pytest.raises(FileNotFoundError, match="no hub download"):
        serve.text_codec()


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_run_batch_on_the_cpu(cpu_env, quantize):
    """The outputs are the greedy continuations of build_generator's
    model: ``max_new_tokens`` in-vocab ids per prompt, the pow-2 filler
    row dropped."""
    if quantize:
        cpu_env.setenv("TPUFW_QUANTIZE", quantize)
    results = serve.run_batch(PROMPTS, max_new_tokens=5)
    model, cfg, restored = serve.build_generator()
    assert cfg.quantized_weights is bool(quantize)
    assert (model.layers[0].attn.q.weight.dtype == torch.int8) is bool(quantize)
    want = generate_text(model, PROMPTS, max_new_tokens=5)
    assert [r["output"] for r in results] == want
    for r, p in zip(results, PROMPTS):
        assert r["prompt"] == p and r["restored_checkpoint"] is restored
        assert r["model_params"] == cfg.n_params()
        assert len(r["output"]) == 5
        assert all(0 <= t < cfg.vocab_size for t in r["output"])


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_run_batch_serves_mixtral(cpu_env, quantize):
    """TPUFW_MODEL=mixtral_tiny: build_generator gives a Mixtral decode
    model (int8 expert stacks under TPUFW_QUANTIZE=int8) and run_batch its
    greedy continuations."""
    from tpufw_torch.models import Mixtral

    cpu_env.setenv("TPUFW_MODEL", "mixtral_tiny")
    if quantize:
        cpu_env.setenv("TPUFW_QUANTIZE", quantize)
    results = serve.run_batch(PROMPTS, max_new_tokens=5)
    model, cfg, restored = serve.build_generator()
    assert isinstance(model, Mixtral) and model.cfg.decode and not restored
    assert type(cfg).__name__ == "MixtralConfig"
    experts = model.layers[0].moe.w_up
    assert (experts.weight.dtype == torch.int8 if quantize
            else experts.dtype == torch.float32)
    assert [r["output"] for r in results] == generate_text(
        model, PROMPTS, max_new_tokens=5)
    assert all(r["model_params"] == cfg.n_params() for r in results)


def test_mixtral_serve_slice_is_a_model_name():
    """TPUFW_MODEL=mixtral_8x7b_serve_slice names the smoke test's serve
    weights: Mixtral-8x7B widths at 16 layers, bf16, dropless."""
    from tpufw_torch.configs import resolve_model_preset

    cfg = resolve_model_preset("mixtral_8x7b_serve_slice")
    assert type(cfg).__name__ == "MixtralConfig" and cfg.decode
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff) == (16, 4096, 14_336)
    assert cfg.capacity_factor == cfg.n_experts == 8
    assert cfg.param_dtype == torch.bfloat16 and cfg.max_seq_len == 2048


def test_run_batch_env_knobs(cpu_env):
    """TPUFW_PREFILL_CHUNK leaves greedy outputs as they were; sampled
    output is reproducible; TPUFW_EOS_ID truncates rows after the EOS."""
    base = serve.run_batch(PROMPTS, max_new_tokens=6)
    cpu_env.setenv("TPUFW_PREFILL_CHUNK", "2")
    assert serve.run_batch(PROMPTS, max_new_tokens=6) == base
    cpu_env.setenv("TPUFW_TEMPERATURE", "0.9")
    sampled = serve.run_batch(PROMPTS, max_new_tokens=6)
    assert sampled == serve.run_batch(PROMPTS, max_new_tokens=6)
    cpu_env.delenv("TPUFW_TEMPERATURE")
    first = base[0]["output"][0]
    cpu_env.setenv("TPUFW_EOS_ID", str(first))
    assert serve.run_batch(PROMPTS[:1], max_new_tokens=6)[0]["output"] == [
        first]


def test_decode_unroll_is_a_layout_knob(cpu_env):
    """``tpufw`` reads TPUFW_DECODE_UNROLL to unstack its scanned decode
    trunk (the same tokens either way); the port's layer stacks are
    always an ``nn.ModuleList``, so the knob changes nothing there: the
    same greedy tokens with 0, 1 and unset (ROADMAP.md Queue 3,
    divergences by design)."""
    base = serve.run_batch(PROMPTS, max_new_tokens=6)
    for value in ("0", "1"):
        cpu_env.setenv("TPUFW_DECODE_UNROLL", value)
        assert serve.run_batch(PROMPTS, max_new_tokens=6) == base


def test_main_prints_one_line_per_prompt(cpu_env, tmp_path, capsys):
    path = tmp_path / "prompts.json"
    path.write_text(json.dumps(PROMPTS))
    for k, v in {"PROMPTS_FILE": str(path), "MAX_NEW_TOKENS": "3",
                 "QUANTIZE": "int8", "DECODE_DTYPE": "bfloat16"}.items():
        cpu_env.setenv(f"TPUFW_{k}", v)
    assert serve.main() == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["prompt"] for ln in lines[:-1]] == PROMPTS
    assert all(len(ln["output"]) == 3 for ln in lines[:-1])
    last = lines[-1]
    assert last["generate_ok"] is True and last["n_prompts"] == 3
    assert last["max_new_tokens"] == 3 and last["device"] == "cpu"


UNPORTED = {
    # Ported knobs keep tpufw's own refusals: the spill tier is
    # page-granular.
    "KV_SPILL": ("64", "scheduler", ValueError, "page-granular"),
    "KV_SPILL_DIR": ("/spill", "scheduler", ValueError, "page-granular"),
    # Ported in item 13a (no error): the server writes its telemetry
    # under the directory (a fresh temporary one here).
    "TELEMETRY_DIR": ("<tmp>", "server", None, "trace-serve.json"),
    # The roles are ported (tests/test_torch_migrate.py); a role the
    # port does not know is refused before any model is built.
    "SERVE_ROLE": ("oracle", "main", ValueError, "TPUFW_SERVE_ROLE"),
    # The weight knobs load (test_weight_knobs_load_the_weights); a path
    # that holds no weights raises rather than serving random ones.
    "DRAFT_PARAMS_CHECKPOINT": ("/ckpt", "draft", FileNotFoundError,
                                "/ckpt"),
    "CHECKPOINT_DIR": ("/ckpt", "build_generator", FileNotFoundError,
                       "/ckpt"),
    "PARAMS_CHECKPOINT": ("/ckpt", "build_generator", FileNotFoundError,
                          "/ckpt"),
    "HF_CHECKPOINT": ("/hf", "build_generator", FileNotFoundError, "/hf"),
    "QUANTIZE": ("int4", "build_generator", ValueError, "int8"),
    "DECODE_DTYPE": ("float99", "run_batch", ValueError, "torch dtype"),
    "MODEL": ("gpt5", "build_generator", ValueError, "unknown"),
}


@pytest.mark.parametrize("knob", sorted(UNPORTED))
def test_unported_knobs_raise(cpu_env, knob, tmp_path):
    """Each knob raises its error; one ported since (``err`` None) takes
    effect instead: the server's telemetry writes ``match`` into the
    directory and mounts the profiler behind ``/debug/profile``."""
    value, entry, err, match = UNPORTED[knob]
    if value == "<tmp>":
        value = str(tmp_path)
    cpu_env.setenv(f"TPUFW_{knob}", value)
    if err is None:
        srv = serve._Server(0, 2)
        try:
            assert srv._tel.out_dir == value
            assert srv._tel.profiler is not None
            srv.generate([[1, 5, 9]], 2)
        finally:
            srv.shutdown()
        assert (tmp_path / match).exists()
        assert (tmp_path / "goodput.json").exists()
        return
    call = {"main": serve.main,
            "run_batch": lambda: serve.run_batch(PROMPTS, 2),
            "build_generator": serve.build_generator,
            "server": lambda: serve._Server(0, 2),
            "scheduler": lambda: serve._SlotScheduler(None),
            "draft": lambda: serve.build_draft_model("llama3_tiny", "cpu",
                                                     1)}[entry]
    with pytest.raises(err, match=match):
        call()


# The knobs that were refused until speculation and chunked prefill were
# ported: each runs on the CPU and gives tpufw's greedy tokens on the
# same weights (the draft's weights are random: speculation changes how
# many target passes run, never the tokens).
PORTED = {
    "SERVE_PREFILL_CHUNK": ("scheduler", {"SERVE_PAGE": "16",
                                          "SERVE_PREFILL_CHUNK": "1"}),
    "SERVE_SPEC_K": ("scheduler", {"SERVE_SPEC_K": "4"}),
    "SERVE_SPEC_DRAFT": ("scheduler", {"SERVE_SPEC_K": "3",
                                       "SERVE_SPEC_DRAFT": "llama3_tiny",
                                       "SERVE_PAGE": "16"}),
    "SERVE_SPEC_MIN_ACCEPT": ("scheduler", {"SERVE_SPEC_K": "2",
                                            "SERVE_SPEC_MIN_ACCEPT": "0.9"}),
    "DRAFT_MODEL": ("run_batch", {"DRAFT_MODEL": "llama3_tiny",
                                  "DRAFT_K": "3"}),
}


@pytest.mark.parametrize("knob", sorted(PORTED))
def test_ported_knobs_give_jax_greedy_tokens(cpu_env, knob):
    from tests.torch_parity import decode_pair
    from tpufw.infer import generate_text as j_generate_text

    jmodel, params, model = decode_pair()
    cpu_env.setattr(serve, "build_generator",
                    lambda: (model, model.cfg, False))
    entry, env = PORTED[knob]
    for k, v in env.items():
        cpu_env.setenv(f"TPUFW_{k}", v)
    want = j_generate_text(jmodel, params, PROMPTS, max_new_tokens=6)
    if entry == "run_batch":
        got = [r["output"] for r in serve.run_batch(PROMPTS, 6)]
    else:
        sched = serve._SlotScheduler(model)
        try:
            got = sched.submit(PROMPTS, 6)[0]
            if "SERVE_SPEC_K" in env:
                assert sched.spec_passes > 0
            if "SERVE_PREFILL_CHUNK" in env:
                assert sched.prefill_chunk_pages == 1
        finally:
            sched.close()
    assert got == want


def test_serve_refuses_to_fall_back_to_cpu(clear_tpufw_env):
    clear_tpufw_env.setattr(torch.cuda, "is_available", lambda: False)
    clear_tpufw_env.setenv("TPUFW_MODEL", "llama3_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_generator()


def test_scheduler_page_export_receives_the_exported_state(cpu_env):
    """The scheduler hands each retiring paged row's export_slot() state
    to the page_export hook before the slot is released: the row's pages
    and cursors, which a decode engine splices into the same tokens."""
    from tests.torch_parity import decode_pair
    from tpufw_torch.infer import SamplingConfig
    from tpufw_torch.serve.bundle import decode_bundle, encode_bundle
    from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine

    _jm, _params, model = decode_pair(max_seq_len=64)
    got = {}
    sched = serve._SlotScheduler(
        model, eos_id=None, page=16,
        page_export=lambda job, state: got.setdefault(tuple(job.prompt),
                                                      state),
    )
    try:
        outs = sched.submit(PROMPTS, 4)[0]
    finally:
        sched.close()
    assert sorted(got) == sorted(tuple(p) for p in PROMPTS)
    greedy = SamplingConfig()
    pe = PrefillEngine(model, sampling=greedy, page=16)
    de = DecodeEngine(model, sampling=greedy, page=16)
    for p, out in zip(PROMPTS, outs):
        state = got[tuple(p)]
        assert len(out) == 4
        assert state["n_pages"] == 1 and state["kv_quant"] == ""
        # Exported after the last chunk (k=4 steps): the budget is spent,
        # the row froze (it feeds pad back), and the cursor sits past the
        # prompt and the decoded tokens (a done row steps on to the
        # chunk's end).
        assert state["remaining"] == 0 and state["done"] is True
        assert state["token"] == 0
        assert state["cache_index"] == len(p) + 4
        # The pages hold the prompt's K/V as a prefill replica exports it.
        ref = decode_bundle(pe.prefill(p, 4))
        assert state["paths"] == ref["paths"]
        for a, b in zip(state["arrays"], ref["arrays"]):
            np.testing.assert_allclose(a[:, :, :len(p)], b[:, :, :len(p)],
                                       rtol=2e-4, atol=2e-4)
        # A done bundle splices and releases its pages at once.
        slot = de.submit(encode_bundle(state))
        assert de.collect(slot) == [0]
        assert de.pool.allocator.in_use == 0


def test_main_dispatches_a_serve_role(cpu_env, monkeypatch):
    from tpufw_torch.serve import roles

    seen = []
    monkeypatch.setattr(roles, "main_role", lambda r: seen.append(r) or 7)
    cpu_env.setenv("TPUFW_SERVE_ROLE", "decode")
    assert serve.main() == 7 and seen == ["decode"]


def test_unknown_role_is_refused_before_building(cpu_env, monkeypatch):
    from tpufw_torch.serve import roles

    monkeypatch.setattr(serve, "build_generator", lambda: 1 / 0)
    with pytest.raises(ValueError, match="want prefill|decode|router"):
        roles.main_role("oracle")


def test_build_engine_on_the_cpu(cpu_env):
    from tpufw_torch.serve import roles

    cpu_env.setenv("TPUFW_SERVE_SLOTS", "2")
    cpu_env.setenv("TPUFW_MAX_SEQ_LEN", "64")
    engine, restored = roles._build_engine("prefill")
    assert isinstance(engine, roles.PrefillEngine) and restored is False
    assert engine.pool.model.device.type == "cpu"
    assert engine.signals()["pages_total"] == 2 * 64 // 16
    engine, _ = roles._build_engine("decode")
    assert isinstance(engine, roles.DecodeEngine) and engine.chunk == 16


def test_roles_refuse_to_fall_back_to_cpu(clear_tpufw_env):
    from tpufw_torch.serve import roles

    clear_tpufw_env.setattr(torch.cuda, "is_available", lambda: False)
    clear_tpufw_env.setenv("TPUFW_MODEL", "llama3_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roles._build_engine("prefill")


def test_server_refuses_to_fall_back_to_cpu(clear_tpufw_env):
    """Without TPUFW_DEVICE=cpu the server builds its model on cuda, and
    on a machine without a GPU that raises."""
    clear_tpufw_env.setattr(torch.cuda, "is_available", lambda: False)
    clear_tpufw_env.setenv("TPUFW_MODEL", "llama3_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve._Server(0, 2)


@pytest.fixture
def tiny_weights(tmp_path):
    """(bare-params dir, training-checkpoint dir, the state dicts in
    them) of llama3_tiny, from seed 5 and one step of training."""
    from tpufw_torch.models import PRESETS
    from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
    from tpufw_torch.train.checkpoint import save_params

    cfg = PRESETS["llama3_tiny"]
    t = Trainer(cfg, TrainerConfig(batch_size=2, seq_len=17, total_steps=1,
                                   checkpoint_dir=str(tmp_path / "ck"),
                                   checkpoint_every=1), device="cpu")
    t.init_state(seed=5)
    params = {k: v.clone() for k, v in t.model.state_dict().items()}
    save_params(str(tmp_path / "p"), params, cfg)
    t.run(synthetic_batches(2, 17, cfg.vocab_size), 1.0)
    return str(tmp_path / "p"), str(tmp_path / "ck"), params, \
        t.model.state_dict()


@pytest.mark.parametrize("knob", ["PARAMS_CHECKPOINT", "CHECKPOINT_DIR"])
def test_weight_knobs_load_the_weights(cpu_env, tiny_weights, knob):
    """The served model holds exactly the saved weights (restored is
    True) and run_batch gives generate_text's tokens on them."""
    from tpufw_torch.workloads.env import env_str

    params_dir, ckpt_dir, params, trained = tiny_weights
    path, want = ((params_dir, params) if knob == "PARAMS_CHECKPOINT"
                  else (ckpt_dir, trained))
    cpu_env.setenv(f"TPUFW_{knob}", path)
    model, cfg, restored = serve.build_generator()
    assert restored and cfg.decode is False and model.cfg.decode
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    out = serve.run_batch(PROMPTS, max_new_tokens=3)
    assert [r["output"] for r in out] == generate_text(
        model, PROMPTS, max_new_tokens=3)
    assert all(r["restored_checkpoint"] for r in out)
    # Another preset's params are refused, not served.
    cpu_env.setenv("TPUFW_MODEL", "qwen25_tiny")
    with pytest.raises(ValueError, match="different model"):
        serve.build_generator()
    assert env_str(knob.lower(), "") == path


def test_draft_params_checkpoint_loads_the_draft(cpu_env, tiny_weights):
    params_dir, _, params, _ = tiny_weights
    cpu_env.setenv("TPUFW_DRAFT_PARAMS_CHECKPOINT", params_dir)
    draft = serve.build_draft_model("llama3_tiny", "cpu", 1)
    assert draft.cfg.decode
    got = draft.state_dict()
    assert all(torch.equal(got[k], params[k]) for k in params)


def test_tokenizer_directory(clear_tpufw_env, tmp_path):
    """TPUFW_TOKENIZER=<local dir>: encode and decode are the HF
    tokenizer's (built in memory, no download)."""
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    vocab = {"[UNK]": 0, "hello": 1, "world": 2, "tpu": 3}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, "[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok,
                                                unk_token="[UNK]")
    fast.save_pretrained(tmp_path)
    clear_tpufw_env.setenv("TPUFW_TOKENIZER", str(tmp_path))
    encode, decode = serve.text_codec()
    assert encode("hello world tpu") == [1, 2, 3]
    assert decode([1, 3]) == fast.decode([1, 3])
