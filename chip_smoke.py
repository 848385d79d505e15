#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpufw_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. builds the flash-attention CUDA kernels from ``tpufw_torch/ops/csrc``
   (nvcc, sm_90a) into ``build-torch/``, at head dim 128 and, from the
   ``*_d192.cu`` and ``*_d256.cu`` sources, 192 and 256; prints the card's
   name and power limit, and reads the build: each kernel's registers and
   spills from ``-Xptxas -v`` and each library's ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions from ``cuobjdump -sass``. Every
   kernel (fwd, dq, dk/dv at the three head dims) must use both and spill
   nothing;
2. holds each kernel (fwd, dq, dk/dv) against its plain PyTorch version,
   run in fp32 on the same bf16 inputs, at the train path's shapes
   (B=2, T=S=2047, 32/8 heads of 128, causal), on a small case with
   segments, a t<s offset, window 300 and soft cap 50 together, and on
   tile-edge cases: T=S=129 and 64, two batches of 700 (a batch's padding
   rows must not see the next batch), t=100 under s=300, windows 128 and
   129, segment boundaries inside tiles. The head-dim-256 kernels
   likewise, at the Gemma-2-9B train path's shapes (B=1, T=S=8191, 16/8
   heads, causal, soft cap 50), global and with window 4096, on the small
   masks case and on T=S=129 and 64. The head-dim-192 kernels at the
   DeepSeek MLA train path's shapes (B=8, T=S=2047, 16/16 heads, causal),
   with V's last 64 columns zero as the model pads it and with V random,
   on the small masks case and on T=S=129 and 64. The head-dim-128
   kernels also at phase 7b's shapes (``llama3_600m_bench``: B=4,
   T=S=2047, 12/6 heads, causal). At every head dim, the ring's
   full-chunk mode (``CHUNK_MODE``): t=s=600, non-causal at offsets 600
   and 1,200, with and without window 900 and segments, O compared on the
   rows that see a key;
3. times each kernel, its plain version and the library yardstick
   (``F.scaled_dot_product_attention``, which the port never calls) with
   CUDA events, beside the roofline bound computed from the shapes, and
   the whole backward (delta, dq, dk/dv and the two GQA sums) against
   SDPA's one backward call; at head dim 128 at the Llama path's shapes,
   at 256 at the Gemma path's, global and windowed (SDPA then takes a
   boolean mask; it has no soft cap), at 192 at the MLA path's (SDPA also
   with V at its own 128 columns, and the SDPA backend that ran); and
   head dim 128 at phase 7b's shapes (the kernels line's
   ``at_600m_shapes``);
4. trains 5 steps of Llama-3-8B widths cut to 4 layers (B=2, seq 2048,
   chunked CE, remat at the default policy "dots", flash attention)
   through ``Trainer.run`` with the launch counters zeroed just before,
   and checks that every loss is finite and every kernel was launched;
   prints one ``Trainer.evaluate`` loss on a held-out batch; then checks
   the trained model's flash logits against its plain-attention logits
   on a small input. Then the same 5 steps under the remat policies
   "nothing", "attn_out" and "everything", and "dots" once more (the
   run-to-run noise), each with its ``train_summary`` (step time,
   tokens/s, MFU, peak memory, launches): every policy's losses within
   REMAT_LOSS_TOL of the first "dots" run's; and 5 steps at
   ``sync_every=4``, whose metrics must be windows of 1, 3 and 1 steps.
   4b. The same for Gemma-2-9B widths cut to 4 of 42 layers (B=1, seq
   8192, chunked CE with the final cap 30, flash at head dim 256, its own
   counters): every head-dim-256 kernel launched, flash vs plain logits
   on 4,160 tokens (past the 4096 window); a ``gemma_train_summary``
   line. 4c. The same for ``deepseek_mla_bench`` at all 10 layers (B=8,
   seq 2048, chunked CE, flash at head dim 192 with V zero-padded, its own
   counters): every head-dim-192 kernel launched, flash vs plain logits on
   256 tokens; an ``mla_train_summary`` line;
5. frees the trainer and serves Llama-3-8B at full width and
   LLAMA_SERVE_LAYERS = 16 of its 32 layers (phase 8 serves all 32)
   (``llama3_8b_serve_slice``: 4 prompts of 7, 64, 200 and 511 tokens, 32
   greedy tokens each, a 2048-slot KV cache) through ``run_batch``'s
   generation path, with bf16 weights and then with int8 weights. Every
   output must hold 32 in-vocab tokens; the cached path's logits must
   agree with an uncached forward of the same model at the last prompt
   position and at one decode step of one row; computed in fp32, the
   int8 logits must stay within 5% of the largest logit of the bf16
   weights they were quantized from. A
   ``serve_summary`` line per weight dtype gives prefill and decode
   times, tokens/s and the decode step's HBM bound. With the bf16
   weights it also runs ``run_batch``'s speculative path with the target
   itself as the draft (k = 4): full-length in-vocab outputs, and the
   verify block's logits (one pass of k+1 tokens) within 5% of k+1
   teacher-forced single steps; a ``serve_spec_summary`` line gives
   passes, accepted drafts per pass, tokens/s and greedy agreement with
   the plain run. The serve path runs plain PyTorch attention: no flash
   kernel may launch there. 5b. The same checks for Gemma-2-9B at full
   width and GEMMA_SERVE_LAYERS = 8 of its 42 layers
   (``gemma2_9b_serve_slice``, weights drawn in bf16), bf16 then int8, a
   ``gemma_serve_summary`` line per dtype. 5c.
   The same checks for ``deepseek_mla_bench`` at all 10 layers
   (``deepseek_mla_serve_slice``: 8 prompts of 128 ids, 128 greedy tokens,
   a 256-slot latent cache) through the absorbed latent-cache decode, the
   cached logits against an uncached expanded forward; an
   ``mla_serve_summary`` line per dtype;
6. serves Llama-3-8B's widths (bf16, drawn from seed 0, at ONLINE_LAYERS
   = 4 of its 32 layers, a 2048-slot ceiling) online through the HTTP
   server (``_Server``: slot scheduler, 8 slots, greedy) on a localhost
   port, in three modes: contiguous KV,
   paged KV (page 64) and paged int8 KV. Each gets 16 concurrent SSE
   requests (prompts of 7, 64, 200 and 511 ids, four of each, 64 tokens
   each); the paged modes also 4 requests sharing a 448-token prefix, and
   the contiguous mode a liveness pair (a short request sent after a long
   one must finish first) and an SSE and a JSON request for one prompt
   that must agree. Checks: every output holds 64 in-vocab tokens,
   ``/metrics`` counts the requests and tokens sent, ``/healthz`` is ok,
   no slot is occupied after the drain, no flash kernel launched; paged:
   a prefix hit, and after the drain only the trie's pages in use. One
   admission sequence straight through a contiguous and a paged pool
   gives step logits within 5% (int8 KV: within 5% of the bf16 KV
   pool's). Then three more modes, paged bf16 KV: chunked prefill (4
   pages, 256 tokens, a chunk; the paged traffic, then a head-of-line
   pair, a 1,536-token prompt and 10 ms later a 7-token one, whose first
   token must come first; the paged mode measures the same pair
   without chunking), n-gram speculation (k = 4; the 16 requests, then 4
   self-similar 512-token prompts) and speculation with a draft pool on
   the target itself (k = 4; the 16 requests; after the drain only the
   trie's pages are in use, so the draft pool leaked none). Direct
   checks: chunked vs monolithic prefill of the four direct prompts and
   a 1,536-token one (first-step logits within 5%, bit-equality and the
   share of equal K/V and int8 codes printed), and a verify block vs k+1
   teacher-forced single steps on a contiguous and a paged pool (within
   5%). An ``online_summary`` line per mode gives wall time, tokens/s,
   client-side TTFT p50/p95, latency p50, decode ms per step, peak memory
   and peak pages, and the new modes their chunks, passes, ms per pass,
   accept rate and fallback slots. Then two more modes: ``tick``, the
   tick batcher (``TPUFW_SERVE_SLOTS=0``), with the 16 prompts as
   concurrent SSE clients (a stream is a tick of its own) and then as
   concurrent JSON clients (coalesced into ticks): full-length in-vocab
   outputs, the /metrics counts, and the four direct prompts' greedy
   tokens equal to ``generate_text`` on the rows their ticks ran; and
   ``paged_spill`` (bf16, then int8 KV), the spill tier
   (``TPUFW_KV_SPILL``) behind a 14-page arena: the 448-token prefix's 7
   pages are evicted into the tier by 8 short requests and restored by a
   request sharing the prefix, bit-equal; directly on a pool, the
   restored admission's first-step logits within 5% of a cold prefill's,
   and the spill and restore times per page.

7. weights and state, with phase 6's models freed, in a gitignored
   directory of the checkout that is deleted as it goes. 7a: about 16 M
   byte tokens of text drawn from a seed, packed by
   ``tools.pack_corpus``; the native packer (``libtpufwdata``, built
   from ``native/dataloader`` by ``ops/_build.py``) must load, its
   first 32 batches at B=4, seq 2048 must equal the Python packer's bit
   for bit, and ``prefetch_to_device`` must hand out CUDA tensors equal
   to the host batches; a ``data_summary`` line (native batches/s, host
   ms per batch against the 600m step). 7b: ``llama3_600m_bench`` at
   full width and depth (596 M parameters, 14 layers, B=4, seq 2048,
   chunked CE, remat ``dots``) through ``Trainer.run`` on that corpus
   via ``prefetch_to_device``, 6 steps with a checkpoint every 3, launch
   counters zeroed just before; a fresh trainer restores step 3 and
   trains steps 4-6 on the same batches: the restored tensors'
   checksums equal those taken at the save, losses 4-6 and the final
   parameters bit-equal to the first run's, every head-dim-128 kernel
   launched in both runs; a ``checkpoint_summary`` line (bytes, save ms
   on the step path and what it waited for, background write s, restore
   s and GB/s). 7c: ``python -m tpufw_torch.workloads.train_llama`` as a
   child on the corpus, SIGTERM after its second step line: it must
   print ``{"preempted": true, "step": N}``, exit 0 and leave step N on
   disk; a second child with ``TPUFW_TOTAL_STEPS=N+2`` must resume at N
   and train 2 finite steps; a ``preemption_summary`` line. 7d: the
   phase-5 Llama-3-8B weights at LLAMA_HF_LAYERS = 8 of 32 layers (bf16,
   drawn from seed 0) exported with ``export_hf`` as sharded safetensors
   (two files; fails if fewer than 24 GB are free) and served back through
   ``TPUFW_HF_CHECKPOINT`` and ``serve.build_generator``: the four
   prompts' greedy tokens and prefill logits bit-equal to the in-memory
   model's, and under ``TPUFW_QUANTIZE=int8`` every int8 code and scale
   equal to quantizing the in-memory model; an ``hf_import_summary`` line
   (write and load s and GB/s, peak host RSS, which must stay under an
   fp32 copy).

8. disaggregated serving of the same Llama-3-8B weights (bf16, all 32
   layers, drawn from seed 0 once more, pages of 16 tokens, a decode
   engine of 8 slots, greedy), in a gitignored directory of the checkout
   that is deleted after. 8a: the four phase-5 prompts (32 tokens each)
   through ``PrefillEngine`` -> ``LoopbackTransport`` -> ``DecodeEngine``
   with a decoy page in the decode arena, bf16 then int8 KV: the tokens
   bit-equal to a never-migrated run through one paged pool of the
   decode engine's shape (their greedy agreement with ``generate_text``'s
   batched contiguous decode is printed, not held: bf16 near-ties flip
   with the shapes); no flash launch; a ``migrate_summary`` line per KV dtype (export, encode, wire,
   bundle decode and splice times per page, bundle bytes per page, the
   511-token prompt's TTFT split into prefill compute and migration).
   8b: ``serve_prefill``/``serve_decode`` on loopback TCP behind a
   ``RouterServer`` over ``TcpReplica``s: phase 6's 16 prompts and its 4
   sharing the 448-token prefix (64 tokens each) with the four phase-5
   prompts, concurrently: every reply full-length and in vocabulary,
   ``/metrics`` counting the requests and tokens sent, ``/healthz`` ok
   with no slot occupied after, the phase-5 prompts' tokens equal to 8a's,
   no flash launch; then a session (the 511-token prompt, 128 tokens)
   drained off the decode engine after its first chunk, re-homed by the
   router from the spill directory onto a second decode engine on the
   same weights: the client's tokens equal the undisturbed run's; a
   ``disagg_summary`` line (tokens/s, the router's TTFT p50/p95, latency
   p50, the router's stage breakdown). 8d: the closed autoscaling loop on
   8b's weights and the decode engine its drain left in rotation, beside
   a fresh prefill engine (as 8b's), behind a ``RouterServer`` of its own:
   a ``FleetCollector`` over the router and both replicas, an
   ``SloTracker`` of 4 s/12 s windows, a ``ScalingRecommender`` on
   ``deploy/manifests/13-serve-disagg-v5e8-jobset.yaml`` subscribed by a
   ``GangExecutor`` whose decode factory serves a new ``DecodeEngine`` on
   the same weights over loopback TCP. A seeded mmpp burst of the
   "burst" tenant (per-token target 0.1 us, so every request violates)
   through ``ReplayClient`` over the router's HTTP port, the collector
   sweeping every 0.5 s beside it. Held in causal order: the pre-traffic
   sweep sees every replica live and no alert; the burn-rate pair fires
   (schema-valid ``fleet_alert`` events); exactly one decision (decode
   +1) with its manifest artifact; a third replica in ``/healthz`` and a
   ``scale_action`` add; the spawned replica serves (its signals count
   migrations, replies name it) and the four phase-5 prompts give 8a's
   bf16 tokens; relaxed targets give ``scale_action`` recovered; idle
   traffic gives decode -1 and the executor drains and removes only its
   own replica; no flash launch. A ``fleet_loop_summary`` line (seconds
   from the first violation to the alert, from the alert to the
   decision, from the decision to the spawned replica's first token; the
   collector's CPU seconds a sweep; the artifact). Then ``run_sweep`` on
   the same gang (rungs of 0.5, 1, 2 and 4 requests/s, 5 s hold, 1 s
   settle, ``SweepConfig``'s targets: TTFT 2 s, 0.2 s a token) and a
   ``load_sweep_summary`` line (per rung offered and achieved rps,
   attainment, TTFT p50/p95, the router's stage means; the knee). 8c:
   ``python -m tpufw_torch.workloads.serve`` as three children,
   ``TPUFW_SERVE_ROLE`` prefill, decode and router, on
   ``llama3_8b_serve_slice`` from ``TPUFW_SEED=0`` (fails early below 40
   GB free): the four prompts through the router's HTTP port give 8a's
   bf16 tokens; the router child runs its fleet collector
   (``TPUFW_FLEET_SCRAPE_S=0.5``): its startup line says ``"fleet":
   true``, its ``fleet-series.jsonl`` holds records of the router and
   both replicas and ``python -m tpufw_torch.obs.fleet query`` returns
   them; a fourth child, ``python -m tpufw_torch.load replay``, sends a
   3 s ``TPUFW_LOAD_*`` poisson mix through the router, every request
   served, and leaves a trace ``read_trace`` reads; SIGTERM drains the
   decode child, which exits 0; each child's startup seconds.

9. Mixtral-8x7B widths (8 experts of 14336, top 2; ``tpufw_torch.ops.moe``
   routing), with phase 8's models freed. 9a: ``mixtral_8x7b_train_slice``
   (2 of 32 layers, 3.16 B parameters, B=2, seq 2048, chunked CE,
   capacity factor 1.25, flash at head dim 128) through ``Trainer.run``
   for 5 steps with the launch counters zeroed just before, under the
   einsum dispatch and then, freed, under the sorted one from the same
   seed on the same batches: finite losses, every head-dim-128 kernel
   launched in both runs, the flash vs plain logits of the einsum run,
   and the two runs' step-1 losses and gradient norms within
   MIXTRAL_LOSS_TOL and MIXTRAL_GNORM_TOL (the gap printed); a
   ``mixtral_train_summary`` per mode. 9b: ``mixtral_8x7b_serve_slice``
   at MIXTRAL_SERVE_LAYERS = 2 of 32 layers (bf16 weights drawn in bf16,
   dropless capacity 8.0) through phase 5's checks in bf16 and then int8
   (``quantize_model`` freeing each bf16 weight as its codes are made),
   with the number of
   tokens whose router top-k sets differ between the runs each check
   compares; a ``mixtral_serve_summary`` per dtype. 9c, between the two:
   the bf16 model behind ``_Server`` (8 slots, paged KV of page 64,
   greedy) with phase 6's 16 concurrent SSE requests and the 4 sharing
   the 448-token prefix, 64 tokens each: full-length in-vocab replies,
   ``/metrics`` counts, ``/healthz``, a prefix hit, no slot occupied
   after, no flash launch, and one admission sequence through a
   contiguous and a paged pool with step logits within 5%; a
   ``mixtral_online_summary``. 9d: 2 layers of the serve slice (6.3 GB)
   through 7d's HF round trip, bit-equal, in a gitignored directory of
   the checkout that is deleted after.

10. DeepSeek-V2-Lite (MLA with a 576-value latent cache; 64 routed
    experts of 1408, top 6, 2 shared, layer 0 dense; yarn rope), with
    phase 9's models freed. 10a: ``deepseek_v2_lite_train_slice`` (3 of
    27 layers, 1.67 B parameters, B=2, seq 2048, chunked CE, capacity
    factor 1.25, flash at qk head dim 192) for 5 steps under each
    dispatch, as 9a: finite losses, every head-dim-192 kernel launched in
    both runs, the flash vs plain logits on 256 tokens, the step-1 gaps; a
    ``v2lite_train_summary`` per mode. 10b: ``deepseek_v2_lite_serve_slice``
    at V2LITE_SERVE_LAYERS = 3 of its 27 layers (bf16 weights drawn in
    bf16, dropless, a 4096-slot ceiling) through phase 5's checks in bf16
    and then int8, the absorbed
    latent decode against the expanded forward; a ``v2lite_serve_summary``
    per dtype. Between the two, on the bf16 model: 10c, the server with 8
    slots in contiguous, paged (page 64) and paged int8 latent KV modes,
    phase 6's 16 SSE requests and the 4 sharing the 448-token prefix, 64
    tokens each, with 9c's checks per mode, the contiguous vs paged step
    logits and ``spec_pool_check``; a ``v2lite_online_summary`` per mode;
    and 10d, 8a's migration at pages of 64 (bf16 and int8 latent pages),
    bit-equal to the never-migrated run; a ``v2lite_migrate_summary`` per
    KV dtype. 10e: 3 layers of the serve slice (3.34 GB) through 7d's HF
    round trip, bit-equal. Every logits check replays the other side's
    routing and prints the top-6 flips (MOE_CHECKS).

11. LoRA, with phase 10's models freed. 11a:
    ``llama3_8b_lora_train_slice``, Llama-3-8B at all 32 layers (the
    8.03 B fp32 base frozen, rank-16 adapters on the seven projections,
    41.9 M parameters; B=2, seq 2048, chunked CE, remat ``dots``, flash
    at head dim 128) for LORA_STEPS = 6 steps through ``Trainer.run``,
    counters zeroed just before: finite losses, every head-dim-128 kernel
    launched; (a) step 0's logits (B = 0) bit-equal to the rank-0 model's
    on the same base tensors; (b) after training every base tensor's
    checksums unchanged and every adapter moved; (c) ``merge_lora``'s
    rank-0 model against the unmerged one on 256 tokens, computed by fp32
    twins on the same tensors: each row within 2^-6 of its largest
    |logit| (the bf16 logits' gap and top-1 agreement printed beside the
    bf16 noise floor, the unmerged bf16 model against its fp32 twin); (d)
    ``quantize_params`` refuses the unmerged state dict and quantizes the
    merged one. A ``lora_train_summary`` (step ms, tokens/s, MFU from the
    ``Meter``'s 6N count of the base, peak memory, launches). 11b:
    Mixtral-8x7B widths at 2 layers with rank-16 adapters on the attention
    and the expert stacks, 3 steps under each dispatch, counters zeroed
    before each: finite losses, every head-dim-128 kernel launched, (b);
    the step-1 losses printed; a ``mixtral_lora_train_summary`` per mode.

12. Vision, with phase 11's models freed: ViT-B/16 (bf16, remat) and
    ResNet-50 (``norm_dtype`` bf16, the workload's default) through
    ``VisionTrainer.run``, batch 256 of 224 px synthetic images staged on
    the card, 6 steps each: finite losses; for ResNet-50 every BatchNorm
    running statistic moved, and on 16 images an eval-mode forward is
    deterministic, leaves the statistics as they are, moves when a
    running variance does and differs from a train-mode forward. A
    ``vision_train_summary`` per model (images/s, MFU against the card's
    bf16 peak, peak memory). No flash kernel runs here: ViT's attention is
    two matmuls and a softmax, as in the reference.

13. Post-training, with phase 12's models freed; its data files (drawn
    from a seed) in a gitignored directory of the checkout, deleted after.
    13a SFT: ``llama3_8b_lora_train_slice`` (all 32 layers, rank 16, B=2,
    seq 2048, remat ``dots``, flash at head dim 128) for SFT_STEPS steps on
    ``sft_batches`` of synthetic multi-turn conversations (``llama3``
    template, ``resolve_encode("bytes")``): finite losses, every run of
    trained target positions part of an assistant turn (checked on the
    host from the batches), the base's checksums unchanged and every
    adapter moved; an ``sft_train_summary``. 13b DPO: the same slice,
    DPO_PAIRS pairs (4 rows) of DPO_SEQ tokens, beta 0.1, DPO_STEPS steps,
    the reference the policy's base with the adapters bypassed: step 0 at
    ln 2 within 1e-6 with accuracy 0.5 (the largest |margin| printed),
    finite later steps, the base unchanged; a ``dpo_train_summary`` (MFU
    on the 4/3 count, margins and accuracy a step). 13c GRPO: the same
    slice, 2 prompts x group 8 rows of 256 tokens, 64 sampled at
    temperature 1, kl_beta 0.02, 3 steps of ``run_rl`` with the
    ``low_token`` reward: completions in vocab, rows right-padded with the
    mask on the completion only, every step's mean ratio within 1e-6 of 1
    with no clip, step 1's KL 0, no flash launch in any rollout's decode
    and every d128 kernel in each update; a ``grpo_summary`` (decode,
    scoring and update ms and tokens/s, rewards). 13d distillation: the
    student ``llama3_600m_bench`` (full size, full fine-tune, B=4, seq
    2048) and a frozen bf16 teacher ``llama3_1b_proxy`` (16 layers, the
    same 32,768 vocab), T 2, alpha 0.5, 5 steps: finite KL > 0 and CE, and
    the chunked loss on the card within 2^-6 of an unchunked fp32
    computation of the same formula on 256 tokens; a
    ``distill_train_summary`` (MFU with the teacher's forward). 13e
    embeddings, 8 pairs (16 rows) of 256 tokens, 3 steps of each recipe,
    rank-16 adapters at all 32 layers: E5-Mistral (``mistral_7b``,
    causal, last-token pooling, temperature 0.02) and LLM2Vec
    (``llama3_8b``, ``causal=False``: the flash kernels non-causal, mean
    pooling, 0.05): finite InfoNCE losses, every d128 kernel launched,
    ``embed`` unit-norm [N, D], a changed last token moving the first
    position only under the bidirectional trunk, ``evaluate_retrieval``;
    an ``embed_train_summary`` per recipe. Every sub-phase zeroes the
    launch counters just before its run.

14. The mesh on the card, with phase 13's models freed. NCCL takes one
    rank per device, so on one card the gang is a world-1 NCCL group,
    which the phase starts itself on a localhost ``TCPStore``
    (``cluster.init_process_group``; ``initialize_cluster`` is a no-op
    for one process) after 14a's unwrapped run and destroys at its end.
    14a: ``llama3_600m_bench`` at full size (B=4, seq 2048, remat
    ``dots``), MESH_STEPS steps through the unwrapped ``Trainer``, then
    through the sharded one (``fully_shard`` of every block and the root,
    DTensor parameters and moments) from the same seed on the same
    batches: losses and grad norms within MESH_TOL relative (bit-equal
    expected; the largest gap printed), the flash launch counts equal. A
    sharded run's stop request()ed after step 1 goes through
    ``should_stop``'s all-reduce MAX of an int32 on the card, writes one
    forced checkpoint (the state gathered tensor by tensor), and a
    sharded resume of it gives the unbroken run's step-2 loss and grad
    norm bit for bit. A ``mesh_train_summary`` (both runs' step ms, peak
    memory, ``card_state``). 14b: ``llama3_8b_lora_train_slice`` (all 32
    layers, rank 16) sharded, MESH_LORA_STEPS steps from 11a's seed on
    11a's batches: losses within MESH_TOL of 11a's unwrapped ones, the
    base's checksums unchanged, every adapter moved; a
    ``mesh_lora_train_summary`` (step ms, peak memory).
15. sequence parallelism (``tpufw_torch.parallel``). 15a: one-process
    rings (``LocalSequenceGroup``) at full width, bf16, forward and
    backward, against whole-sequence ``flash_attention`` (the kernels),
    O, dQ, dK and dV within ROW_TOL of each row's largest value
    (``SEQ_CASES``): Llama-3-8B attention at 16,384 tokens over 4 shards,
    causal and with packed segments (a chunk's rows fully masked);
    Gemma-2-9B at 8,192 over 4, cap 50, global and with window 4096 (3 of
    4 live steps); ``deepseek_mla_bench`` at B=8 x 4,096 over 2, V
    zero-padded to 192; Ulysses over 4 at Llama's shapes; and 1,024
    tokens over 4 with segments, cap and window against the plain
    reference in fp32. Ring-flash's launches by chunk case (full,
    diagonal) must be the live chunks' count, n(n+1)/2 forwards for a
    causal ring of n; each case prints forward and backward ms beside
    whole-sequence flash's. 15b: ``train_llama.build_trainer`` in a
    world-1 NCCL group with TPUFW_ATTENTION flash, ring and ulysses,
    ``llama3_600m_bench`` at full size for MESH_STEPS steps: ring's and
    ulysses' losses and grad norms within MESH_TOL of flash's (bit-equal
    expected: a ring of one shard), their launches equal. A
    ``sequence_summary`` line per sub-phase.
16. pipeline parallelism (``tpufw_torch.parallel.pipeline``, one process
    holding both stages of a ``LocalPipeGroup(2)``). 16a:
    ``llama3_600m_bench`` at full size (7 layers a stage, B=RESUME_BATCH x
    RESUME_SEQ, PIPE_M microbatches) through ``PipelineTrainer`` under
    gpipe, 1f1b, zb1 and interleaved at v = 7, 1 + PIPE_STEPS steps each
    from seed 0; 16b: ``deepseek_mla_bench``, nothing cut (5 layers a
    stage, B=PIPE_MLA_BATCH), gpipe and 1f1b. First the kernels at a
    microbatch's shapes against their plain versions. Checks: step 0's
    loss and grad norm of every schedule within PIPE_TOL relative of
    GPipe's, GPipe's loss within PIPE_TOL of ``reference_forward``'s (the
    sequential oracle, row by row), every loss finite, and the flash
    launches of each run equal to PIPE_PER_LAYER's prediction (per layer
    per microbatch: GPipe 1/1/1, 1F1B and interleaved 2/1/1, ZB-H1 3/2/2)
    with nothing else launched. A ``pipeline_summary`` line per schedule
    (step ms, peak GB, launches, the analytic bubble fraction and
    ``n_ticks``: one process runs both stages in turn, so the step time
    shows each schedule's extra compute, not its bubble).
17. GRPO, contrastive embeddings and vision under the mesh, in a world-1
    NCCL group the phase starts and destroys itself (as phase 14), each
    run held to its unwrapped run of an earlier phase from the same seeds
    and batches. 17a: 13c's GRPO (the LoRA slice at all 32 layers, 13c's
    prompts, group, lengths and seed) for MESH_GRPO_STEPS steps of
    ``run_rl`` sharded, the decode view over the rank's own shards (no
    copy of the base): every rollout's tokens equal to 13c's, the mean
    ratio within RATIO_TOL of 1, losses, KL and grad norms within
    MESH_TOL of 13c's (absolute below 1), no flash launch in a decode,
    every d128 kernel in each update and the launches by part 13c's per
    step; peak memory beside 13c's. 17b: 13e's recipes on its models and
    pairs for MESH_EMBED_STEPS steps each, the pooled vectors gathered
    over the gang: losses, grad norms and metrics within MESH_TOL of
    13e's, the d128 launches (LLM2Vec's non-causal) 13e's per step,
    ``embed`` refused in the gang. 17c: phase 12's ViT-B/16 and ResNet-50
    at batch VISION_BATCH for MESH_VISION_STEPS steps of their schedule:
    losses, and ResNet's BatchNorm running statistics after the last
    step, within MESH_TOL of phase 12's. A ``gang_post_summary`` line per
    sub-phase (step ms, peak GB, ``card_state``, beside the earlier
    run's).
18. Tensor and expert shards in one process (``tensor_phase``): 18a
    ``llama3_600m_bench`` over ``LocalTensorGroup(2)``, 18b the V2-Lite
    slice over tensor 2 x expert 2, 18c the Gemma-2-9B slice over tensor
    2, each against its unsplit run (losses and grad norms within
    TENSOR_TOL, split launches the tensor size times the unsplit ones).
19. The post-trainers and the pipelines over the shards, in one process
    (``tensor_pipe_phase``), each case trained from seed 0 unsplit and
    split on the same batches, the flash counters zeroed just before
    each run: 19a ``llama3_600m_bench`` full-parameter over
    ``LocalTensorGroup(2)``: DPO, distillation from a
    ``llama3_600m_bench`` teacher of seed 1, E5 (causal, last token) and
    GRPO (one rollout, one update); 19b ``llama3_600m_bench`` through
    GPipe and 1F1B over ``LocalPipeGroup(2)`` x ``LocalTensorGroup(2)``
    at phase 16a's batch; 19c ``deepseek_mla_bench`` through GPipe over
    pipe 2 x tensor 2 (d192); 19d the V2-Lite slice at 2 layers (uniform
    MoE stages) through GPipe over pipe 2 x tensor 2 x expert 2. Checks:
    split losses and grad norms within TENSOR_TOL of the unsplit ones,
    DPO's step 0 at ln 2 and GRPO's ratio 1.0 on both runs, GRPO's
    rollout tokens equal, each run's launches the code's count
    (POST_TP_PER_LAYER, PIPE_PER_LAYER) and the split run's the tensor
    size times it. A ``tensor_summary`` line per case (step ms, peak GB,
    ``card_state``).
20. Telemetry (``telemetry_phase``): 20a ``llama3_600m_bench`` through
    ``train_llama``'s ``build_trainer`` at phase 7b's shapes for TEL_STEPS
    steps with ``TPUFW_TELEMETRY_DIR``, ``TPUFW_PROFILE_DIR``,
    ``TPUFW_METRICS_PORT=0`` and ``TPUFW_PROFILE_STEPS=4:6``: a scrape of
    ``/metrics`` during the run holds the step, MFU and data-wait series;
    every event passes the schema, run_start and run_end among them;
    ``goodput.json``'s categories sum to its wall time; the spans of
    ``trace.json`` cover the step loop; ``programs.json``'s ``train_step``
    holds FLOPs, bytes, intensity, bound and peak memory, its FLOPs within
    TEL_FLOP_BAND of the model FLOPs of a step and its flash share the
    ``flash_costs`` of the step's launches; the ``torch.profiler`` trace
    holds the d128 flash kernels by name as often as the launch counts of
    the two profiled steps (TEL_STEP_LAUNCHES a step), with its busy, idle
    and flash shares printed. 20b: the same run with telemetry off,
    TEL_RUNS runs of each kind, the two kinds at once in processes of
    their own taking turns step by step: the telemetry runs' median step
    (TEL_MEDIAN_STEPS of each run, pooled: neither the counted step nor
    the profiled ones) within TEL_OVERHEAD_TOL of the others', each
    telemetry run's counted step out of its Meter's histogram, each run's
    launches TEL_STEP_LAUNCHES a step. 20c: phase
    6's model behind a server with ``TPUFW_TELEMETRY_DIR``: a
    ``/debug/profile?seconds=1`` capture during TEL_SERVE_PROMPTS streams
    holds decode kernels and no flash kernel, no flash launch, and the
    serve trace, goodput tables and decode programs are written. A
    ``telemetry_train``, ``telemetry_summary`` and ``telemetry_serve``
    line.
21. The tensor and expert axes on the last paths, in one process
    (``seq_tensor_phase``), each case trained from seed 0 unsplit and
    split on the same batches, the flash counters zeroed just before each
    run: 21a ``llama3_600m_bench`` at full width over
    ``LocalTensorGroup(2)`` beside a ``LocalSequenceGroup(2)`` ring
    (2048 trained positions, chunks of 1024), with ``ring`` (ring-flash)
    and then ``ulysses``, against the same ring unsplit (d128 at 6/3
    heads a shard); 21b the V2-Lite slice's layers over
    ``LocalExpertGroup(2)`` beside the ring (MLA at d192, 32 routed
    experts a shard); 21c ``llama3_8b_lora_train_slice``'s widths at
    SEQTP_LORA_LAYERS layers over ``LocalTensorGroup(2)`` (the adapters
    split with their weights; only the adapters move); 21d ViT-B/16 at
    ``MeshConfig(tensor=2)`` (its heads, MLP and class head split; no
    flash kernel on its path; its class head drawn nonzero). Checks:
    split losses and grad norms (ViT: losses) within TENSOR_TOL of the
    unsplit ones, each run's launches
    the count of its shards, ring chunks and remat passes
    (``seqtp_launches``), no other kernel launched. The kernels are first
    checked against their plain versions at a shard's ring-chunk and
    Ulysses shapes. A ``seq_tensor_summary`` line per case (step ms, peak
    GB, ``card_state``).
22. The memory estimate, the tuner, the YAML run config and the other
    tile builds on their train paths (``autotune_phase``; see the
    comment above it).
23. The smoke and validate workloads and the port's lint
    (``workload_lint_phase``; no flash kernel): 23a ``python -m
    tpufw_torch.workloads.smoke`` as a child at its defaults
    (SMOKE_DIM, SMOKE_REPS), held to ``SMOKE OK``, a CUDA device line and
    a finite checksum, its effective TFLOP/s printed; 23b
    ``validate.run_checks()`` in this process, held to the device nodes,
    ``libcuda.so.1`` and torch's device (the allocation env is printed,
    not held: the card's machine runs outside Kubernetes); 23c ``python
    -m tpufw_torch.analysis --layer python tpufw_torch`` under the card's
    Python, held to exit 0 within LINT_TIMEOUT_S, and a child that
    imports the lint's CLI and loads neither torch nor JAX. A
    ``smoke_summary``, ``validate_summary`` and ``lint_summary`` line.

It ends with a ``{"kernels": [...]}`` line (nine kernels: three per head
dim; the head-dim-128 ones also carry ``launches_resume_600m``, phase
7b's first run, ``launches_mixtral_train``, phase 9a's runs per dispatch
mode, ``launches_lora_train``, phase 11a's,
``launches_mixtral_lora_train``, phase 11b's per mode, and
``launches_post_train``, phase 13's per sub-phase, GRPO's decode,
scoring and updates apart, ``launches_mesh``, phase 14's sharded runs,
and the head-dim-192 ones
``launches_v2lite_train``, phase 10a's; every kernel carries
``launches_sequence``, phase 15's ring runs, and ``launches_pipeline``,
phase 16's runs by sub-phase and schedule; the head-dim-128 ones
``launches_gang_post``, phase 17's runs, GRPO's decode, scoring and
updates apart; every kernel ``launches_tensor``, phase 18's split runs,
``launches_tensor_post_pipeline``, phase 19's, and
``launches_seq_tensor``, phase 21's; the head-dim-128 ones
``launches_telemetry``, phase 20's two train runs), a ``phase_seconds``
line (each phase's wall seconds, phase 10's to 21's parts and the
total), the
``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repo, it prints no result and exits nonzero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

# The ring's full-chunk mode, at every head dim: a q shard of 600 against
# a kv chunk of 600 wholly before it, non-causal at the chunk distance
# (offset 600 or 1,200), with and without window 900 and segments; the
# segment lengths over [0, offset + 600) leave some rows seeing no key.
# name suffix: masks.
CHUNK_MODE = {
    f"chunk_offset{off}{'_window900' if win else ''}"
    f"{'_segments' if seg else ''}": (
        {"causal": False, "offset": off} | ({"window": win} if win else {})
        | ({"chunk_segments": (300, off - 100, 400)} if seg else {}))
    for off in (600, 1200) for win in (None, 900) for seg in (False, True)
}
# Tolerances: kernel vs its plain version in fp32 on the same bf16 inputs.
# O, dQ, dK and dV are held row by row, a row being one query's or one
# key's head vector: every |got - want| within ROW_TOL of the largest
# |want| in its own row, so that a late row's small values cannot hide
# behind an early row's large ones. bf16 rounds to 2^-8 of a value; P and
# dS are rounded to bf16 for the tensor-core products and O and dQ are
# stored in bf16, hence 2^-6. A row whose true value is zero (dQ of a
# query that sees one key: dS = 0) holds only rounding noise, so a row's
# scale is at least ROW_FLOOR of the tensor's largest |want|. The whole
# tensor is also held to FRO_TOL in relative Frobenius norm. LSE is
# absolute (its sums stay fp32).
ROW_TOL = 2.0 ** -6
ROW_FLOOR = 1e-3
FRO_TOL = 1e-2
LSE_TOL = 1e-3
# Train slice: flash logits vs plain-attention logits of the same bf16
# model, relative to the logits' max magnitude.
LOGITS_TOL = 5e-2
N_LAYERS = 4
STEPS = 5
# Remat policies: each policy's 5 losses against the default ("dots")
# run's, absolute. The policy changes what the forward keeps, never the
# arithmetic, so the only allowance is the run-to-run noise of one
# configuration, which a repeat of "dots" in the same call measures. On
# an H100 80GB HBM3 at 700 W it was 0.0: every kernel on this path sums
# in a fixed order, and the five runs' losses were bit-equal.
REMAT_LOSS_TOL = 0.0
# Gemma-2-9B train slice depth: 2 (local, global) pairs of its 42 layers.
GEMMA_TRAIN_LAYERS = 4
# Phase 5 serves LLAMA_SERVE_LAYERS of Llama-3-8B's 32 layers (phase 8
# serves all 32) and 5b GEMMA_SERVE_LAYERS of Gemma-2-9B's 42 (4 pairs):
# their decode is host-bound, a cost per layer, and the whole script took
# 1,100 s on a slow host once 8d came, 1,049 s with 5b at 14 layers and
# 9b-c and 10b-d cut too (H100 80GB HBM3 at 700 W).
LLAMA_SERVE_LAYERS = 16
GEMMA_SERVE_LAYERS = 8
# deepseek_mla_bench trains at its full depth.
MLA_TRAIN_LAYERS = 10
# Serve slice, each relative to the reference logits' largest magnitude:
# cached vs uncached logits of one bf16 or int8 model; and
# tests/test_quant.py's rule, int8 vs the weights it was quantized from,
# both computed in fp32 as that test does, at every prompt position. The
# same int8 error with bf16 activations (as served) adds the bf16 path's
# own rounding noise; it is printed, not held (PERF.md, serve slice).
SERVE_LOGITS_TOL = 5e-2
INT8_TOL = 5e-2
SERVE_REPS = 3
# Speculative decoding: drafts per pass, in phase 5 (self-draft) and in
# phase 6's spec modes.
SPEC_K = 4
# Online phase: 16 requests, four prompts of each length, ONLINE_NEW
# greedy tokens each, over ONLINE_SLOTS slots; the paged modes add four
# requests sharing an ONLINE_PREFIX-token prefix (7 pages of ONLINE_PAGE).
# The liveness pair is a 511-token prompt with ONLINE_LONG_NEW tokens and
# a 7-token one with 8. The direct pool comparison runs at ONLINE_CACHE
# slots, the cache the longest requests get. Its step logits are held to
# SERVE_LOGITS_TOL (paged vs contiguous, both bf16 KV) and INT8_TOL (int8
# KV vs bf16 KV).
ONLINE_PROMPT_LENS = (7, 64, 200, 511)
ONLINE_NEW = 64
ONLINE_LONG_NEW = 256
ONLINE_PREFIX = 448
ONLINE_PAGE = 64
ONLINE_SLOTS = 8
ONLINE_CACHE = 1024
# Phase 6 serves Llama-3-8B's widths at ONLINE_LAYERS of its 32 layers:
# its decode is host-bound, a cost per layer; at 32 layers its nine modes
# took 221 s of the script's 1200, at 16 layers 159-169 s, at 8 101 s on
# a slower host, where the whole script took 1,129 s with phase 20 (H100
# 80GB HBM3 at 700 W): phase 20 needed the room.
ONLINE_LAYERS = 4
# The modes this slice added: chunked paged prefill in chunks of
# ONLINE_CHUNK_PAGES pages (256 tokens), with the head-of-line pair, a
# HOL_LONG-token prompt with ONLINE_NEW tokens and, HOL_GAP_S later, a
# 7-token one with 8 (the short one's first token must come first;
# ONLINE_MAX_CACHE slots, the long prompt's cache); n-gram speculation
# with 4 extra self-similar prompts (a SELFSIM_PATTERN-token pattern
# repeated to SELFSIM_LEN tokens); speculation with a draft pool on the
# target itself. The direct chunked-vs-monolithic check adds a HOL_LONG
# prompt to the four direct ones, at ONLINE_MAX_CACHE slots.
ONLINE_CHUNK_PAGES = 4
ONLINE_MAX_CACHE = 2048
HOL_LONG = 1536
HOL_GAP_S = 0.010
SELFSIM_PATTERN = 16
SELFSIM_LEN = 512
# The paged_spill mode's arena: 14 usable pages of ONLINE_PAGE. The
# prefix request (448 + 16 tokens, 64 new) takes 9 and leaves the prefix's
# 7 in the trie; 8 short requests of 2 pages each then need 16, so the 7
# must go to the spill tier; after them the arena is free again, and the
# request sharing the prefix restores all 7.
SPILL_ARENA_PAGES = 15
# Phase 7, weights and state. 7a: a corpus of about CORPUS_TOKENS byte
# tokens, generated from a seed as lines of random words, packed by
# tools.pack_corpus; the first PARITY_BATCHES batches at B=RESUME_BATCH,
# seq RESUME_SEQ bit-equal between the native and Python packers. 7b:
# llama3_600m_bench at full width and depth, B=RESUME_BATCH, seq RESUME_SEQ,
# RESUME_STEPS steps with a checkpoint every RESUME_EVERY, then a fresh
# trainer restored at RESUME_EVERY trains the rest: losses and parameters
# bit-equal. 7c: the train_llama entry point as a child, SIGTERM after its
# second step line, then resumed for 2 steps. 7d: Llama-3-8B's serve slice
# at LLAMA_HF_LAYERS layers exported as sharded safetensors and served back
# through TPUFW_HF_CHECKPOINT, which needs HF_DISK_GB free. 8 of 32 layers
# (5.6 GB of bf16, still two 5 GB shards), for the script's time limit:
# the round trip's format, shards and int8 codes are per tensor, so more
# layers add bytes and no case.
CORPUS_TOKENS = 16 * 2**20
PARITY_BATCHES = 32
RESUME_BATCH = 4
RESUME_SEQ = 2048
RESUME_STEPS = 6
RESUME_EVERY = 3
SIGTERM_TOTAL_STEPS = 50
HF_DISK_GB = 24
LLAMA_HF_LAYERS = 8
# Phase 8, disaggregated serving of the Llama-3-8B serve slice: pages of
# DISAGG_PAGE tokens (2 MiB of bf16 K and V over 32 layers), a decode
# engine of DISAGG_SLOTS slots (the router admits as many at once), the
# drained session's budget DISAGG_DRAIN_NEW tokens, and the free memory
# 8c needs for its two 16 GB children and their arenas.
DISAGG_PAGE = 16
DISAGG_SLOTS = 8
DISAGG_DRAIN_NEW = 128
DISAGG_FREE_GB = 40
# 8d, the closed autoscaling loop on 8b's gang: SLO windows of
# FLEET_WINDOWS seconds (minutes compressed so the loop closes in
# seconds), a collector sweep every FLEET_SCRAPE_S while traffic runs, the
# recommender's cooldown, the idle rule's hold (longer than the gaps
# between replies under the burst: a scale-in vote during it would cancel
# the burn's scale-out vote), and the seeded mmpp burst of the "burst"
# tenant, whose per-token target (0.1 us) no request meets; the gang serves
# about one request a second on the H100, so the burst offers one a second
# at its base rate with outputs of at most 8 tokens. Then a sweep
# at SWEEP_RUNGS offered requests/s, SWEEP_HOLD_S seconds a rung, the first
# SWEEP_SETTLE_S of each dropped. 8c's router child scrapes every
# FLEET_SCRAPE_S too and its load child replays LOAD_CHILD_S seconds.
FLEET_WINDOWS = (4.0, 12.0)
FLEET_SCRAPE_S = 0.5
FLEET_COOLDOWN_S = 3.0
FLEET_IDLE_HOLD_S = 5.0
FLEET_BURST = dict(seed=20, process="mmpp", rate_rps=1.0, duration_s=3.0,
                   tenants=(("burst", 1.0),), session_ratio=0.2,
                   max_new_cap=8, mmpp_burst_factor=4.0, mmpp_dwell_s=0.8)
SWEEP_RUNGS = (0.5, 1.0, 2.0, 4.0)
SWEEP_HOLD_S = 5.0
SWEEP_SETTLE_S = 1.0
LOAD_CHILD_S = 3.0
# Phase 9, Mixtral-8x7B widths. 9a trains MIXTRAL_TRAIN_LAYERS of its 32
# layers under each dispatch mode. Both modes route the same tokens to the
# same experts with the same gates (bit for bit in fp32 on the CPU,
# tests/test_torch_moe.py); on the card they differ in bf16 rounding:
# einsum sums a token's two weighted expert outputs in fp32 inside one
# matmul and rounds once, sorted rounds each weighted output to bf16 and
# adds the two in bf16, and the expert GEMMs run batched or one per
# expert. That is one bf16 rounding, 2^-8 relative, of each MoE output.
# The step-1 loss, a mean of 4,094 CE terms of the same weights, moves by
# at most that relative perturbation of its inputs: MIXTRAL_LOSS_TOL. The
# global gradient norm sees it again through the backward's bf16
# products: MIXTRAL_GNORM_TOL, the kernels' ROW_TOL. 9d exports
# MIXTRAL_HF_LAYERS layers (6.3 GB of bf16) and needs MIXTRAL_HF_DISK_GB
# free.
MIXTRAL_TRAIN_LAYERS = 2
# 9b and 9c serve MIXTRAL_SERVE_LAYERS of the serve slice's 16 layers, cut
# for the script's time limit when phase 10 came (8), again when phase 20
# came (4) and again when 8d came (2).
MIXTRAL_SERVE_LAYERS = 2
# MOE_CHECKS. A MoE layer's routing is discrete: a token whose router
# logits nearly tie flips experts under a rounding-size change of its
# input, and its output, and through attention those of the tokens after
# it, then moves by far more than the rounding (on the card, 9a's flash vs
# plain logits differed by 5.5% of the largest with free routing). So
# every logits check of a MoE model runs its reference side with the
# other side's router logits replayed (``router_tap``), which pins the
# experts and gates and holds everything else to the dense models'
# tolerance; the free-routing error and the number of token-layers whose
# top-k sets differ are printed beside it, and that share must stay
# within MOE_FLIP_TOL of the token-layers compared. A router whose logits
# told nothing of its input would keep 1 of the C(8, 2) = 28 top-2 sets,
# flipping ~96% (DeepSeek-V2-Lite's top 6 of 64: ~100%); a flip also
# cascades, through attention, into the router inputs of the tokens after
# it. The sets compared are each model's top-k. Measured on the card (H100
# 80GB HBM3 at 700 W): Mixtral at 16 layers 2.3-2.5% (cached vs uncached,
# bf16 and int8 weights) and 7.9% (int8 vs bf16 weights, fp32 compute);
# V2-Lite at 27 layers 12.0% and 18.3%, its 6th and 7th experts' gates
# lying closer than Mixtral's 2nd and 3rd.
MOE_FLIP_TOL = 0.25
MIXTRAL_LOSS_TOL = 2.0 ** -8
MIXTRAL_GNORM_TOL = 2.0 ** -6
MIXTRAL_HF_LAYERS = 2
MIXTRAL_HF_DISK_GB = 10
# Head dim 256 (Gemma-2-9B): the train path's attention shapes (B=1, seq
# 8192, so T = S = 8191 inputs after the target shift; 16 query / 8 kv
# heads), attention soft cap 50, window 4096 on the local layers. Kernel
# checks: the path's shapes, global and windowed, then the small masks case
# and the tile edges of the 128 x 64 (forward, dQ) and 64 x 64 (dK/dV)
# tiles. name: (b, t, s, heads, kv heads, input scale, masks, segment
# lengths or None).
GEMMA_T = 8191
GEMMA_ATTN_CAP = 50.0
GEMMA_WINDOW = 4096
D256_CASES = {
    "d256_path_shapes_causal_cap50": (
        1, GEMMA_T, GEMMA_T, 16, 8, 4.0,
        {"causal": True, "soft_cap": GEMMA_ATTN_CAP}, None),
    "d256_path_shapes_causal_cap50_window4096": (
        1, GEMMA_T, GEMMA_T, 16, 8, 4.0,
        {"causal": True, "soft_cap": GEMMA_ATTN_CAP, "window": GEMMA_WINDOW},
        None),
    "d256_segments_offset_window300_cap50": (
        1, 300, 700, 4, 2, 4.0,
        {"causal": True, "window": 300, "soft_cap": 50.0}, (250, 300, 150)),
    "d256_t129_s129": (1, 129, 129, 4, 2, 1.0, {"causal": True}, None),
    "d256_t64_s64": (1, 64, 64, 4, 2, 1.0, {"causal": True}, None),
    **{f"d256_{name}": (2, 600, 600, 4, 2, 1.0, masks, None)
       for name, masks in CHUNK_MODE.items()},
}
# Head dim 192 (DeepSeek MLA, deepseek_mla_bench): the train path's
# attention shapes (B=8, seq 2048, so T = S = 2047; 16 query and 16 kv
# heads of 128 nope + 64 rope dims), causal, V zero-padded from 128 to 192
# columns by the model ("pad_v": the zero columns). Kernel checks: the
# path's shapes as the model gives them and with a random V (the kernels'
# own contract), the small masks case and the tile edges of the 128 x 64
# (forward, dQ) and 64 x 64 (dK/dV) tiles. Same layout as D256_CASES.
MLA_B, MLA_T, MLA_V = 8, 2047, 128
D192_CASES = {
    "d192_path_shapes_causal_zero_padded_v": (
        MLA_B, MLA_T, MLA_T, 16, 16, 1.0, {"causal": True, "pad_v": 64},
        None),
    "d192_path_shapes_causal": (
        MLA_B, MLA_T, MLA_T, 16, 16, 1.0, {"causal": True}, None),
    "d192_segments_offset_window300_cap50": (
        1, 300, 700, 4, 2, 4.0,
        {"causal": True, "window": 300, "soft_cap": 50.0}, (250, 300, 150)),
    "d192_t129_s129": (1, 129, 129, 4, 2, 1.0, {"causal": True}, None),
    "d192_t64_s64": (1, 64, 64, 4, 2, 1.0, {"causal": True}, None),
    **{f"d192_{name}": (2, 600, 600, 4, 2, 1.0, masks, None)
       for name, masks in CHUNK_MODE.items()},
}
# Model families of the train and serve phases: (preset, the prefix of
# their summary lines).
FAMILIES = {"llama3_8b": ("llama3_8b", ""),
            "gemma2_9b": ("gemma2_9b", "gemma_"),
            "deepseek_mla": ("deepseek_mla_bench", "mla_"),
            "mixtral_8x7b": ("mixtral_8x7b", "mixtral_"),
            "deepseek_v2_lite": ("deepseek_v2_lite", "v2lite_")}
# Phase 10, DeepSeek-V2-Lite (64 routed experts of 1408, top 6, 2 shared,
# layer 0 dense; MLA with a 576-value latent cache). 10a trains
# V2LITE_TRAIN_LAYERS of its 27 layers under each dispatch mode, held to
# phase 9a's MIXTRAL_LOSS_TOL and MIXTRAL_GNORM_TOL (the same one bf16
# rounding of each MoE output separates the modes). 10b-10d serve
# V2LITE_SERVE_LAYERS of its 27 layers: their decode is host-bound, a cost
# per layer, and at 27 layers they took 240-284 s of the script's 1200,
# at 14 layers 141 s on that slower host (H100 80GB HBM3 at 700 W), so 7
# since phase 20 (74 s on a slow host), and 3 since 8d. 10c serves at
# pages of ONLINE_PAGE; 10d migrates pages of V2LITE_PAGE (3 layers x 64
# tokens x 1,152 bf16 bytes = 0.22 MB a page). 10e exports V2LITE_HF_LAYERS layers (3.34 GB of bf16)
# and needs V2LITE_HF_DISK_GB free.
V2LITE_TRAIN_LAYERS = 3
V2LITE_SERVE_LAYERS = 3
V2LITE_PAGE = 64
V2LITE_HF_LAYERS = 3
V2LITE_HF_DISK_GB = 8
# Phase 11 (LoRA): Llama-3-8B at all 32 layers, LORA_STEPS steps
# (llama3_8b_lora_train_slice); merged vs unmerged bf16 logits, each row
# within LORA_MERGE_TOL of that row's largest |logit|, on LORA_TOKENS
# tokens; then Mixtral-8x7B LoRA at MIXTRAL_TRAIN_LAYERS layers for
# MIXTRAL_LORA_STEPS steps a dispatch mode.
LORA_STEPS = 6
LORA_TOKENS = 256
LORA_MERGE_TOL = 2.0 ** -6
MIXTRAL_LORA_STEPS = 3
# Phase 12 (vision): ViT-B/16 and ResNet-50 at batch VISION_BATCH, 224 px,
# VISION_STEPS steps each; the eval checks on VISION_EVAL_BATCH images.
VISION_BATCH = 256
VISION_STEPS = 6
VISION_EVAL_BATCH = 16
# Phase 13 (post-training). 13a SFT and 13b DPO (beta DPO_BETA) and 13c
# GRPO on llama3_8b_lora_train_slice (all 32 layers, rank 16): SFT at the
# slice's B=2 x 2048 for SFT_STEPS steps on SFT_CONVERSATIONS synthetic
# conversations; DPO_PAIRS pairs of DPO_SEQ tokens for DPO_STEPS steps,
# step 0 held to ln 2 within DPO_ANCHOR_TOL; GRPO GRPO_PROMPTS prompts (of
# GRPO_PROMPT_LENS ids) x group GRPO_GROUP rows of GRPO_SEQ tokens,
# GRPO_NEW sampled, kl_beta GRPO_KL_BETA, GRPO_STEPS steps, every step's
# mean ratio within RATIO_TOL of 1. 13d distills llama3_1b_proxy into
# llama3_600m_bench at B=DISTILL_BATCH x RESUME_SEQ for DISTILL_STEPS
# steps, the chunked loss (chunks of DISTILL_CHECK_CHUNK) within
# DISTILL_TOL of its plain computation on DISTILL_CHECK_TOKENS tokens.
# 13e trains EMBED_RECIPES (preset, causal, pooling, temperature) with
# rank-16 adapters at all 32 layers, EMBED_PAIRS pairs of EMBED_SEQ
# tokens, EMBED_STEPS steps each.
SFT_STEPS = 4
SFT_CONVERSATIONS = 24
DPO_PAIRS, DPO_SEQ, DPO_STEPS, DPO_BETA = 2, 1024, 4, 0.1
DPO_ANCHOR_TOL = 1e-6
GRPO_PROMPTS, GRPO_GROUP, GRPO_SEQ, GRPO_NEW = 2, 8, 256, 64
GRPO_PROMPT_LENS = (100, 150)
GRPO_STEPS, GRPO_KL_BETA = 3, 0.02
RATIO_TOL = 1e-6
DISTILL_BATCH, DISTILL_STEPS = 4, 5
DISTILL_CHECK_TOKENS, DISTILL_CHECK_CHUNK = 256, 64
DISTILL_TOL = 2.0 ** -6
# Phase 14 (the mesh): sharded steps of the 600m model and of the LoRA
# slice, and the relative gap allowed against the unwrapped runs (the
# same numbers are expected bit for bit at world size 1).
MESH_STEPS = 3
MESH_LORA_STEPS = 2
MESH_TOL = 1e-6
EMBED_RECIPES = {"e5_mistral": ("mistral_7b", True, "last", 0.02),
                 "llm2vec": ("llama3_8b", False, "mean", 0.05)}
EMBED_PAIRS, EMBED_SEQ, EMBED_STEPS = 8, 256, 3
# Phase 17 (the whole-batch objectives under the mesh): the steps of 13c's
# GRPO, of each 13e recipe and of each phase-12 model run again sharded
# in a world-1 NCCL group, held to the earlier runs within MESH_TOL.
MESH_GRPO_STEPS, MESH_EMBED_STEPS, MESH_VISION_STEPS = 2, 2, 3
# Wall seconds of each phase (and of phase 10's parts), printed as the
# ``phase_seconds`` line.
PHASE_SECONDS: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# The card's state beside a phase's numbers: a card whose clocks sit
# below their maximum runs every kernel slower.
CARD_STATE = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(torch, got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def kernel_errors(torch, got, want) -> dict:
    """Max abs error; ``row``: the largest |got - want| over the largest
    |want| of its row (last axis), floored at ROW_FLOOR of the tensor's;
    ``fro``: ||got - want|| / ||want||."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row_max = want.abs().amax(-1, keepdim=True)
    floor = ROW_FLOOR * row_max.max()
    return {
        "max_abs": diff.max().item(),
        "ref_max": row_max.max().item(),
        "row": (diff / torch.maximum(row_max, floor)).max().item(),
        "fro": (torch.linalg.vector_norm(diff)
                / torch.linalg.vector_norm(want)).item(),
    }


# Kernels redesigned for Hopper: each must issue wgmma and TMA loads and
# spill nothing. name: (library, kernel symbol substring). The head-dim-192
# and 256 libraries build the same kernels from the same sources.
HOPPER_KERNELS = {"flash_fwd": ("flash_fwd", "flash_fwd_kernel"),
                  "flash_dq": ("flash_dq", "flash_dq_kernel"),
                  "flash_dkv": ("flash_dkv", "flash_dkv_kernel"),
                  "flash_fwd_d192": ("flash_fwd_d192", "flash_fwd"),
                  "flash_dq_d192": ("flash_dq_d192", "flash_dq"),
                  "flash_dkv_d192": ("flash_dkv_d192", "flash_dkv"),
                  "flash_fwd_d256": ("flash_fwd_d256", "flash_fwd"),
                  "flash_dq_d256": ("flash_dq_d256", "flash_dq"),
                  "flash_dkv_d256": ("flash_dkv_d256", "flash_dkv"),
                  # The other tile builds (flash.BUILDS) of the same
                  # kernels, held to the same rules.
                  **{name: (name, name.split("_")[0] + "_"
                            + name.split("_")[1])
                     for name in ("flash_fwd_k64", "flash_dq_k64",
                                  "flash_dkv_k64", "flash_fwd_d192_q64",
                                  "flash_dq_d192_q64", "flash_fwd_d256_q64",
                                  "flash_dq_d256_q64")}}
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")


def ptxas_kernels(log: str) -> dict:
    """Per kernel symbol in an ``-Xptxas -v`` log: registers and spill
    bytes (stores + loads)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
            out.setdefault(name, {})
        elif name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name]["spill_bytes"] = nums[1] + nums[2]
        elif "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out.setdefault(name, {})
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used", 1)[1].split()[0])
    return out


def build_report(build_mod, paths) -> dict:
    """SASS instruction counts per library and registers/spills per
    kernel; raises when a redesigned kernel lacks wgmma or TMA or spills."""
    cuobjdump = os.path.join(os.path.dirname(build_mod._nvcc()), "cuobjdump")
    report = {}
    for name, path in paths.items():
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        log = build_mod.PTXAS_LOG.get(name, "")
        report[name] = {
            "sass": {op: sum(ln.count(op) for ln in sass.splitlines())
                     for op in SASS_OPS},
            "kernels": ptxas_kernels(log),
            # e.g. C7515: a wgmma batch serialized (printed, not held).
            "warnings": [ln.strip() for ln in log.splitlines()
                         if "warning" in ln.lower()],
        }
    for kname, (lib, symbol) in HOPPER_KERNELS.items():
        sass = report[lib]["sass"]
        if not sass["HGMMA"] or not sass["UTMALDG"]:
            raise AssertionError(f"{kname}: no wgmma or no TMA load in SASS {sass}")
        spills = [v.get("spill_bytes") for k, v in report[lib]["kernels"].items()
                  if symbol in k]
        if not spills or any(s is None or s > 0 for s in spills):
            raise AssertionError(f"{kname}: spills {spills} (ptxas)")
    return report


def case_masks(torch, masks, seg_lens, bs, ts, ss) -> dict:
    """A phase-2 case's kernel masks on the card. ``seg_lens``: segment
    lengths over the s keys, the queries the last t of them. A ring
    chunk's case (masks "offset", non-causal) gives its lengths as
    "chunk_segments", over the global positions [0, offset + t): the keys
    are the chunk's first s, the queries [offset, offset + t)."""
    masks = dict(masks)
    chunk_lens = masks.pop("chunk_segments", None)

    def ids(lens):
        return torch.cat([torch.full((n,), i + 1, dtype=torch.int32)
                          for i, n in enumerate(lens)]).to("cuda")[None]

    if seg_lens is not None:
        kseg = ids(seg_lens).expand(bs, ss).contiguous()
        masks |= {"qseg": kseg[:, ss - ts:].contiguous(), "kseg": kseg}
    if chunk_lens is not None:
        full = ids(chunk_lens).expand(bs, -1)
        off = masks["offset"]
        masks |= {"qseg": full[:, off:off + ts].contiguous(),
                  "kseg": full[:, :ss].contiguous()}
    return masks


def build_names(flash, d, block_sizes) -> dict:
    """{kernel: the build name a launch at head dim ``d`` under the tile
    override ``block_sizes`` runs} (``flash.resolve_tiles``)."""
    return {base: flash.BUILDS[d][base][flash.resolve_tiles(base, d,
                                                           block_sizes)]
            for base in flash.KERNELS}


def check_kernels(torch, flash, case, q, k, v, do, masks, builds=(None,)):
    """Each kernel vs its plain version (fp32) on the same inputs, at each
    tile override of ``builds`` (None: the head dim's default builds; the
    plain versions are computed once, a tiling never changes the math). A
    query row that sees no key (a ring chunk's window or segments) has LSE
    ≈ -1e30 on both sides, and its O, an average over whatever tiles
    were visited, weighs nothing where it is used (the ring's merge):
    O is compared on the other rows. Returns ({build name: max abs
    error}, LSE, delta)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = flash.flash_fwd_reference(qf, kf, vf, **masks)
    delta = flash.flash_delta(o_ref, dof)
    dq_ref = flash.flash_dq_reference(qf, kf, vf, dof, lse_ref, delta, **masks)
    dk_ref, dv_ref = flash.flash_dkv_reference(
        qf, kf, vf, dof, lse_ref, delta, **masks
    )
    b, t, s = q.shape[0], q.shape[1], k.shape[1]
    seen = flash._mask(t, s, s - t if masks.get("offset") is None
                       else masks["offset"], masks.get("causal", True),
                       masks.get("window"), masks.get("qseg"),
                       masks.get("kseg"), q.device)
    live = seen.any(-1)[:, 0].expand(b, t)
    dead_rows = int((~live).sum())
    o_want = o_ref[live] if dead_rows else o_ref
    d = q.shape[-1]
    out = {}
    for blocks in builds:
        o, lse = flash.flash_fwd(q, k, v, **masks, block_sizes=blocks)
        dq = flash.flash_dq(q, k, v, do, lse_ref, delta, **masks,
                            block_sizes=blocks)
        dk, dv = flash.flash_dkv(q, k, v, do, lse_ref, delta, **masks,
                                 block_sizes=blocks)
        torch.cuda.synchronize()
        if dead_rows:
            o = o[live]
        errs = {}
        for name, got, want in (("o", o, o_want), ("dq", dq, dq_ref),
                                ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"{case}: {name} has non-finite values")
            errs[name] = kernel_errors(torch, got, want)
        lse_abs = (lse - lse_ref).abs().max().item()
        names = build_names(flash, d, blocks)
        emit({
            "check": case, "errors": errs, "lse_max_abs": lse_abs,
            "dead_rows": dead_rows,
            **({} if blocks is None else {
                "block_sizes": list(blocks), "builds": names}),
            "tol": {"row": ROW_TOL, "row_floor": ROW_FLOOR, "fro": FRO_TOL,
                    "lse_abs": LSE_TOL},
        })
        bad = [n for n, e in errs.items()
               if e["row"] > ROW_TOL or e["fro"] > FRO_TOL]
        if lse_abs > LSE_TOL:
            bad.append("lse")
        if bad:
            raise AssertionError(f"{case} {names}: {bad} past tolerance")
        for name, err in ((names["flash_fwd"],
                           max(errs["o"]["max_abs"], lse_abs)),
                          (names["flash_dq"], errs["dq"]["max_abs"]),
                          (names["flash_dkv"], max(errs["dk"]["max_abs"],
                                                   errs["dv"]["max_abs"]))):
            out[name] = max(out.get(name, 0.0), err)
    return out, lse_ref, delta


def time_kernels(torch, flash, chip, q, k, v, do, lse, delta, masks=None,
                 label="", block_sizes=None, yardsticks=None):
    """kernel / plain / library milliseconds and the roofline bound, keyed
    by each kernel's launch name (``flash_fwd_d256`` at head dim 256; a
    tile override's ``block_sizes`` times its builds, ``flash_fwd_k64``).
    ``masks`` (causal by default; ``soft_cap``, ``window``) are the
    kernels' and the plain versions'. The bound counts the (query, key)
    pairs the masks let through; the library yardstick is SDPA, causal,
    with a boolean mask for a window and no soft cap (it has none).
    ``yardsticks``: this run's timings of the default builds at the same
    inputs, whose plain and SDPA times another build shares (the same
    function on the same inputs) instead of timing them again."""
    import torch.nn.functional as F

    masks = dict(masks or {"causal": True})
    blocks = {"block_sizes": block_sizes}
    window = masks.get("window")
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    # FLOPs and bytes (each input read once, each output written once),
    # the counts the perf observatory adds at each launch.
    work = {base: flash.flash_costs(base, b, t, s, h, kh, d, masks)
            for base in flash.KERNELS}
    calls = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, **masks, **blocks),
                      lambda: flash.flash_fwd_reference(q, k, v, **masks)),
        "flash_dq": (lambda: flash.flash_dq(q, k, v, do, lse, delta, **masks,
                                            **blocks),
                     lambda: flash.flash_dq_reference(q, k, v, do, lse, delta,
                                                      **masks)),
        "flash_dkv": (lambda: flash.flash_dkv(q, k, v, do, lse, delta,
                                              **masks, **blocks),
                      lambda: flash.flash_dkv_reference(q, k, v, do, lse, delta,
                                                        **masks)),
    }
    names = build_names(flash, d, block_sizes)
    if yardsticks is not None:
        return _time_builds(torch, flash, calls, names, work, chip, q, k, v,
                            do, lse, masks, label, block_sizes, yardsticks)
    qh, kh_, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2)
    attn_mask = None
    if window is not None:
        qpos = torch.arange(t, device=q.device)[:, None] + (s - t)
        kpos = torch.arange(s, device=q.device)[None, :]
        attn_mask = (qpos >= kpos) & (qpos - kpos < window)

    def sdpa():
        if attn_mask is not None:
            return F.scaled_dot_product_attention(
                qh, kh_, vh, attn_mask=attn_mask, enable_gqa=True)
        return F.scaled_dot_product_attention(
            qh, kh_, vh, is_causal=True, enable_gqa=True
        )

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa()

    lib_fwd = cuda_ms(torch, sdpa_fwd, 20)
    out = sdpa()
    lib_bwd = cuda_ms(
        torch,
        lambda: torch.autograd.grad(out, (qh, kh_, vh), doh, retain_graph=True),
        20,
    )
    del out
    lib_call = "F.scaled_dot_product_attention" + (
        f" (boolean mask, window {window})" if window else "")
    lib_note = " (no soft cap: SDPA has none)" if masks.get("soft_cap") else ""
    res = {}
    for base, (kernel, plain) in calls.items():
        name = names[base]
        flops, nbytes = work[base]
        t_ops = flops / chip.peak_bf16_flops * 1e3
        t_bytes = nbytes / chip.hbm_bw_bytes_per_s * 1e3
        ms = cuda_ms(torch, kernel, 20)
        res[name] = {
            "ms": ms,
            "plain_ms": cuda_ms(torch, plain, 5, warmup=1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms / 1e9,
            "bound_share": max(t_ops, t_bytes) / ms,
            "flops": flops,
            "bytes": nbytes,
            "library_ms": lib_fwd if base == "flash_fwd" else lib_bwd,
            "library_call": lib_call + (
                " forward" if base == "flash_fwd" else
                " backward (dq, dk, dv together)"
            ) + lib_note,
        }
        emit({"timing": name + label, "shape": [b, t, s, h, kh, d],
              "masks": masks} | res[name])

    # The whole backward as _Flash runs it, against SDPA's one backward.
    o, _ = flash.flash_fwd(q, k, v, **masks)

    def backward():
        dlt = flash.flash_delta(o, do)
        flash.flash_dq(q, k, v, do, lse, dlt, **masks)
        dk_full, dv_full = flash.flash_dkv(q, k, v, do, lse, dlt, **masks)
        flash.gqa_sum(dk_full, kh, k.dtype)
        flash.gqa_sum(dv_full, kh, v.dtype)

    bwd_ms = cuda_ms(torch, backward, 20)
    emit({"timing": "flash_backward_total" + ("" if d == 128 else f"_d{d}") + label,
          "parts": "flash_delta + flash_dq + flash_dkv + 2 gqa_sum",
          "ms": bwd_ms, "library_ms": lib_bwd,
          "library_call": lib_call + " backward" + lib_note,
          "flops": work["flash_dq"][0] + work["flash_dkv"][0],
          "tflops": (work["flash_dq"][0] + work["flash_dkv"][0]) / bwd_ms / 1e9})
    return res


def _time_builds(torch, flash, calls, names, work, chip, q, k, v, do, lse,
                 masks, label, block_sizes, yardsticks) -> dict:
    """``time_kernels``' numbers of the builds a tile override launches
    that are not the head dim's default, the plain and SDPA times taken
    from the default builds' ``yardsticks``; then the whole backward at
    that override beside the default's."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    res = {}
    for base, (kernel, _) in calls.items():
        name, default = names[base], flash.kernel_name(base, d)
        if name == default:
            continue
        flops, nbytes = work[base]
        t_ops = flops / chip.peak_bf16_flops * 1e3
        t_bytes = nbytes / chip.hbm_bw_bytes_per_s * 1e3
        ms = cuda_ms(torch, kernel, 20)
        res[name] = {
            "ms": ms,
            "plain_ms": yardsticks[default]["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms / 1e9,
            "bound_share": max(t_ops, t_bytes) / ms,
            "flops": flops,
            "bytes": nbytes,
            "library_ms": yardsticks[default]["library_ms"],
            "library_call": yardsticks[default]["library_call"],
            "default_build_ms": yardsticks[default]["ms"],
        }
        emit({"timing": name + label, "shape": [b, t, s, h, kh, d],
              "masks": masks, "block_sizes": list(block_sizes)} | res[name])
    blocks = {"block_sizes": block_sizes}
    o, _ = flash.flash_fwd(q, k, v, **masks, **blocks)

    def backward():
        dlt = flash.flash_delta(o, do)
        flash.flash_dq(q, k, v, do, lse, dlt, **masks, **blocks)
        dk_full, dv_full = flash.flash_dkv(q, k, v, do, lse, dlt, **masks,
                                           **blocks)
        flash.gqa_sum(dk_full, kh, k.dtype)
        flash.gqa_sum(dv_full, kh, v.dtype)

    emit({"timing": "flash_backward_total_" + "_".join(
              sorted({names["flash_dq"], names["flash_dkv"]})) + label,
          "block_sizes": list(block_sizes), "ms": cuda_ms(torch, backward,
                                                          20),
          "library_ms": yardsticks[flash.kernel_name("flash_dq", d)][
              "library_ms"]})
    return res


def head_dim_of(cfg) -> int:
    """The head dim the flash kernels see: MLA's qk_head_dim (V is padded
    to it), else ``head_dim``."""
    return getattr(cfg, "qk_head_dim", None) or cfg.head_dim


def sdpa_unequal_v(torch, q, k, v_pad, v_head_dim) -> dict:
    """SDPA (causal) on MLA's own shapes: q and k at the qk head dim, V at
    its ``v_head_dim`` columns (no padding); forward and backward
    milliseconds and the SDPA backend that PyTorch picks for them, beside
    the backend it picks for the zero-padded V of ``time_kernels``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qh, kh_ = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k))
    vh = v_pad[..., :v_head_dim].transpose(1, 2).contiguous().requires_grad_()
    doh = torch.randn_like(vh)

    def backend(v):
        return SDPBackend(torch._fused_sdp_choice(
            qh, kh_, v, None, 0.0, True, scale=None, enable_gqa=False)).name

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh_, vh, is_causal=True)

    fwd_ms = cuda_ms(torch, fwd, 20)
    out = F.scaled_dot_product_attention(qh, kh_, vh, is_causal=True)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qh, kh_, vh), doh, retain_graph=True), 20)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "v_head_dim": v_head_dim,
            "backend": backend(vh),
            "backend_padded_v": backend(v_pad.transpose(1, 2))}


def _steady(history) -> dict:
    """Medians over the steps after the first (the warm-up)."""
    steady = history[1:]
    return {
        "step_ms_median": 1e3 * statistics.median(m.step_time_s
                                                  for m in steady),
        "tokens_per_sec_per_gpu_median": statistics.median(
            m.tokens_per_sec_per_gpu for m in steady),
        "mfu_median": statistics.median(m.mfu for m in steady),
    }


def train_phase(torch, family, n_layers, gen, kind, smi, policy=None,
                logits_check=True, evaluate=False, moe_dispatch=None,
                grad_norms=None) -> tuple[dict, list]:
    """Phase 4 (``family`` "llama3_8b"), 4b ("gemma2_9b"), 4c
    ("deepseek_mla") or 9a ("mixtral_8x7b", under ``moe_dispatch``): the
    family's train slice (``configs.<family>_train_slice``, at
    ``remat_policy`` ``policy`` or the config's default) at ``n_layers``
    for STEPS steps through ``Trainer.run``, launch counters zeroed just
    before. Holds every loss finite and every flash kernel of the model's
    head dim launched; with ``evaluate``, prints one ``Trainer.evaluate``
    loss on a held-out batch (after the counters are read); with
    ``logits_check``, holds the trained model's flash logits against its
    plain-attention logits on an input one window plus 64 tokens long (256
    without a window). ``grad_norms``, a list, receives each step's
    global gradient norm. Returns (the launch counts of the run, its
    losses); raises AssertionError on a failed check."""
    from tpufw_torch import configs
    from tpufw_torch.models import PRESETS, model_for_config
    from tpufw_torch.ops import flash
    from tpufw_torch.train import Trainer, synthetic_batches

    cfg, tcfg = getattr(configs, f"{family}_train_slice")(
        n_layers, total_steps=STEPS)
    if policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=policy)
    if moe_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    preset, prefix = FAMILIES[family]
    full = (PRESETS[preset] if preset in PRESETS
            else getattr(configs, preset)()).n_layers
    window = getattr(cfg, "sliding_window", None)
    trainer = Trainer(cfg, tcfg, device="cuda")
    trainer.init_state(seed=0)
    if grad_norms is not None:
        step_fn = trainer.train_step

        def train_step(batch):
            out = step_fn(batch)
            grad_norms.append(out["grad_norm"])
            return out

        trainer.train_step = train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    emit({"train": f"{family} widths", "reduced": {"n_layers": [full, n_layers]},
          "params": cfg.n_params(), "batch_size": tcfg.batch_size,
          "seq_len": tcfg.seq_len, "loss_chunk_size": tcfg.loss_chunk_size,
          "head_dim": head_dim_of(cfg), "remat": cfg.remat,
          "remat_policy": cfg.remat_policy,
          "attention_backend": cfg.attention_backend,
          "attn_logit_soft_cap": getattr(cfg, "attn_logit_soft_cap", None),
          "final_logit_soft_cap": getattr(cfg, "final_logit_soft_cap", None),
          "sliding_window": window,
          "moe_dispatch": getattr(cfg, "moe_dispatch", None)})
    flash.reset_launch_counts()
    history = trainer.run(
        synthetic_batches(tcfg.batch_size, tcfg.seq_len, cfg.vocab_size, seed=0),
        model_flops_per_token=cfg.flops_per_token(tcfg.seq_len - 1),
        on_metrics=lambda m: emit({prefix + "step": m.as_dict()}),
    )
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = {
        "steps": len(history),
        "losses": [m.loss for m in history],
        **_steady(history),
        "step_time_s_median": statistics.median(
            m.step_time_s for m in history[1:]),
        "peak_mem_gb": peak_gb,
        "launches": launches,
        "remat_policy": cfg.remat_policy,
        "model": family, "n_layers": n_layers, "seq_len": tcfg.seq_len,
        "device": kind, "nvidia_smi": smi,
    }
    if moe_dispatch is not None:
        summary["moe_dispatch"] = moe_dispatch
    if grad_norms is not None:
        grad_norms[:] = [float(g) for g in grad_norms]
        summary["grad_norms"] = grad_norms
    emit({prefix + "train_summary": summary})
    if len(history) != STEPS:
        raise AssertionError(f"{family}: trained {len(history)} of {STEPS} steps")
    if not all(math.isfinite(m.loss) for m in history):
        raise AssertionError(f"{family}: non-finite loss")
    path = [flash.kernel_name(k, head_dim_of(cfg)) for k in flash.KERNELS]
    if not all(launches[k] > 0 for k in path):
        raise AssertionError(
            f"{family}: a kernel was not launched on the train path: {launches}")
    losses = [m.loss for m in history]
    if evaluate:
        ev = trainer.evaluate(synthetic_batches(
            tcfg.batch_size, tcfg.seq_len, cfg.vocab_size, seed=1), 1)
        emit({prefix + "eval": ev, "held_out_seed": 1})
        if not (math.isfinite(ev["eval_loss"]) and ev["eval_tokens"]
                == tcfg.batch_size * (tcfg.seq_len - 1)):
            raise AssertionError(f"{family}: evaluate {ev}")
    trainer.optimizer = None
    if not logits_check:
        return {k: launches[k] for k in path}, losses

    # Output check: flash logits vs the plain path, optimizer state freed.
    trainer.model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    plain_model = model_for_config(
        dataclasses.replace(cfg, attention_backend="xla"), device="cuda")
    plain_model.load_state_dict(trainer.model.state_dict())
    n = 256 if window is None else window + 64
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device="cuda")
    with torch.no_grad():
        with router_tap(torch, trainer.model) as r_flash:
            flash_logits = trainer.model(tokens)
        # A MoE model's plain run takes the flash run's routing (MOE_CHECKS).
        with router_tap(torch, plain_model, r_flash or None):
            plain_logits = plain_model(tokens)
        check = {"check": prefix + "trained_model_flash_vs_plain_logits",
                 "tokens": n}
        if r_flash:
            with router_tap(torch, plain_model) as r_plain:
                check.update(moe_free_routing(
                    torch, flash_logits, plain_model(tokens), r_flash,
                    r_plain, cfg.experts_per_token))
    if flash_logits.shape != (1, n, cfg.vocab_size):
        raise AssertionError(f"{family}: logits shape {tuple(flash_logits.shape)}")
    if not torch.isfinite(flash_logits).all():
        raise AssertionError(f"{family}: non-finite logits")
    abs_e, rel_e = rel_err(torch, flash_logits, plain_logits)
    check.update({"max_abs_err": abs_e, "rel_err": rel_e, "tol": LOGITS_TOL})
    emit(check)
    if rel_e > LOGITS_TOL or check.get("topk_differ_share", 0) > MOE_FLIP_TOL:
        raise AssertionError(f"{family}: flash logits disagree with the plain "
                             f"path: {check}")
    return {k: launches[k] for k in path}, losses


def remat_sweep(torch, gen, kind, smi, dots_losses) -> None:
    """Phase 4's remat policies: the Llama train slice again under
    "nothing", "attn_out" and "everything", and once more under the
    default "dots" to measure the run-to-run noise of the same
    configuration (nondeterministic gradient sums, e.g. the embedding's).
    Each prints its ``train_summary`` (step ms, tokens/s, MFU, peak memory,
    launches). Every policy's losses must equal the first "dots" run's
    within REMAT_LOSS_TOL; raises AssertionError otherwise."""
    out = {}
    for policy in ("nothing", "attn_out", "everything", "dots"):
        launches, losses = train_phase(torch, "llama3_8b", N_LAYERS, gen,
                                       kind, smi, policy=policy,
                                       logits_check=False)
        torch.cuda.empty_cache()
        out[policy] = {"losses": losses, "launches": launches,
                       "max_abs_loss_diff_vs_dots": max(
                           abs(a - b) for a, b in zip(losses, dots_losses))}
    noise = out["dots"]["max_abs_loss_diff_vs_dots"]
    emit({"check": "remat_policy_losses", "dots_losses": dots_losses,
          "policies": out, "dots_repeat_noise": noise,
          "tol": REMAT_LOSS_TOL})
    bad = [p for p, v in out.items()
           if v["max_abs_loss_diff_vs_dots"] > REMAT_LOSS_TOL]
    if bad:
        raise AssertionError(f"remat policies {bad}: losses differ from dots")


def sync_window_run(torch, kind, smi) -> None:
    """Phase 4's ``sync_every``: the Llama train slice for STEPS steps at
    sync_every=4: syncs after steps 1, 4 and 5, windows of 1, 3 and 1
    steps, finite losses; prints a ``sync_window_summary``."""
    from tpufw_torch import configs
    from tpufw_torch.train import Trainer, synthetic_batches

    cfg, tcfg = configs.llama3_8b_train_slice(N_LAYERS, total_steps=STEPS)
    tcfg = dataclasses.replace(tcfg, sync_every=4)
    trainer = Trainer(cfg, tcfg, device="cuda")
    trainer.init_state(seed=0)
    history = trainer.run(
        synthetic_batches(tcfg.batch_size, tcfg.seq_len, cfg.vocab_size, seed=0),
        model_flops_per_token=cfg.flops_per_token(tcfg.seq_len - 1))
    windows = [m.as_dict() for m in history]
    emit({"sync_window_summary": {"sync_every": 4, "windows": windows,
                                  "device": kind, "nvidia_smi": smi}})
    if ([m.step for m in history] != [1, 4, 5]
            or [m.window_steps for m in history] != [1, 3, 1]
            or not all(math.isfinite(m.loss) for m in history)):
        raise AssertionError(f"sync_every=4: windows {windows}")


def host_ms(torch, fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` ending in a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fp32_twin_logits(torch, model, tok, pos, seg, router=None,
                     replay=None):
    """Uncached logits of a twin of ``model`` (same family) that computes
    in fp32 on the same weight tensors (built on the meta device and
    handed them, so no second copy of the weights is held). ``router``, a
    list, receives a MoE twin's router logits, and ``replay`` routes it
    with another run's (``router_tap``)."""
    twin = type(model)(dataclasses.replace(model.cfg, dtype=torch.float32),
                       device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    with torch.no_grad(), router_tap(torch, twin, replay) as rec:
        out = twin(tok, pos, seg)
    if router is not None:
        router.extend(rec)
    return out


def kv_values_per_token(cfg) -> int:
    """Cache values one token holds in one layer: MLA's latent and roped
    key (kv_lora_rank + qk_rope_head_dim), else K and V of every kv head."""
    if hasattr(cfg, "kv_lora_rank"):
        return cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return 2 * cfg.n_kv_heads * cfg.head_dim


def moe_routers(model) -> list:
    """The router modules of a MoE model's MoE layers, in layer order:
    Mixtral's ``moe.router``, DeepSeek's ``moe.routed.router``."""
    return [getattr(layer.moe, "routed", layer.moe).router
            for layer in model.layers if hasattr(layer, "moe")]


def router_tap(torch, model, replay=None):
    """For a MoE model, a context that records each layer's router logits
    [B, T, E] of every forward inside it, in call order, into the list it
    yields; with ``replay``, such a list from another run, each router's
    output is replaced by the recorded one (the other run's routing and
    gates). For a dense model, an empty list."""
    import contextlib

    @contextlib.contextmanager
    def tapping():
        out = []

        def hook(mod, args, y):
            if replay is not None:
                y = replay[len(out)]
            out.append(y)
            return y

        hooks = [r.register_forward_hook(hook) for r in moe_routers(model)]
        try:
            yield out
        finally:
            for h in hooks:
                h.remove()

    return tapping()


def topk_differ(torch, a, b, k, rows=None) -> Optional[int]:
    """Token-layers whose router top-``k`` sets differ between two
    ``router_tap`` recordings of the same shapes; ``rows`` masks the
    [B, T] positions compared. None for a dense model."""
    if not a:
        return None
    n = 0
    for x, y in zip(a, b):
        sx = x.topk(k, dim=-1).indices.sort(-1).values
        sy = y.topk(k, dim=-1).indices.sort(-1).values
        diff = (sx != sy).any(-1)
        n += int((diff & rows).sum() if rows is not None else diff.sum())
    return n


def moe_free_routing(torch, got, want_free, r_got, r_want, k,
                     rows=None) -> dict:
    """The free-routing side of a MoE check (MOE_CHECKS): the relative
    error of ``got`` against the reference run with its own routing,
    and how many token-layers' top-``k`` sets differ (``k`` the model's
    experts per token), also as a share."""
    flips = topk_differ(torch, r_got, r_want, k, rows)
    n = (int(rows.sum()) if rows is not None
         else r_got[0].shape[0] * r_got[0].shape[1]) * len(r_got)
    return {"rel_err_free_routing": rel_err(torch, got, want_free)[1],
            "top_k": k, "topk_differ": flips, "token_layers": n,
            "topk_differ_share": flips / n}


def serve_phase(torch, chip, kind, smi, family="llama3_8b",
                after_bf16=None, n_layers=None) -> None:
    """Phase 5 (``family`` "llama3_8b"), 5b ("gemma2_9b"), 5c
    ("deepseek_mla", the absorbed latent-cache decode) or 9b
    ("mixtral_8x7b"): the serve slice in bf16, then int8 (quantized with
    the bf16 weights freed as their codes are made); raises AssertionError
    on a failed check. Llama's bf16 run is followed by the speculative
    run; ``after_bf16(model)`` runs on the bf16 model before it is
    quantized. For a MoE model the checks print how many tokens' router
    top-k sets differ between the two runs each compares. ``n_layers``
    cuts the slice's depth."""
    from tpufw_torch import configs
    from tpufw_torch.infer import SamplingConfig, generate, pad_prompts
    from tpufw_torch.infer import prefill_cache
    from tpufw_torch.models import model_for_config
    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    kw = {} if n_layers is None else {"n_layers": n_layers}
    cfg, prompts, max_new = getattr(configs, f"{family}_serve_slice")(**kw)
    summary_key = FAMILIES[family][1] + "serve_summary"
    lens = [len(p) for p in prompts]
    emit({"serve": family, "n_layers": cfg.n_layers,
          "params": cfg.n_params(), "param_dtype": "bfloat16",
          "max_seq_len": cfg.max_seq_len, "prompt_lens": lens,
          "max_new_tokens": max_new, "sampling": "greedy",
          "attention_backend": cfg.attention_backend})
    dev = "cuda"
    tokens, pads = pad_prompts(prompts)
    b, p = tokens.shape
    tok = torch.tensor(tokens, device=dev).long()
    pad = torch.tensor(pads, device=dev).long()
    col = torch.arange(p, device=dev)[None, :]
    seg = (col >= pad[:, None]).to(torch.int32)
    pos = torch.clamp(col - pad[:, None], min=0)
    real = seg > 0
    # KV slots the decode steps must read, averaged over the steps: step j
    # attends the prompt plus j tokens.
    kv_tokens = sum(n + max_new / 2 for n in lens)
    kv_bytes = (kv_tokens * cfg.n_layers * kv_values_per_token(cfg)
                * torch.tensor([], dtype=cfg.dtype).element_size())
    model = model_for_config(cfg, device=dev, seed=0)
    for weights in ("bf16", "int8"):
        if weights == "int8":
            model = serve.quantize_model(model, release=True)
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launch_counts()
        outs = serve.generate_batch(model, prompts, max_new, SamplingConfig(),
                                    None)
        torch.cuda.synchronize()
        launches = dict(flash.LAUNCHES)
        if any(launches.values()):
            raise AssertionError(f"serve ({weights}) launched {launches}")
        for o in outs:
            if len(o) != max_new or not all(0 <= t < cfg.vocab_size for t in o):
                raise AssertionError(f"serve ({weights}): bad output {o}")

        def gen(n):
            return generate(model, tok, pad, max_new_tokens=n)

        prefill_ms = host_ms(torch, lambda: gen(1), SERVE_REPS)
        total_ms = host_ms(torch, lambda: gen(max_new), SERVE_REPS)
        decode_ms = (total_ms - prefill_ms) / (max_new - 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        check = {"check": f"serve_{family}_{weights}_cached_vs_uncached_logits",
                 "tol": SERVE_LOGITS_TOL}
        with torch.no_grad():
            # A MoE model's uncached runs take the cached runs' routing
            # (MOE_CHECKS).
            with router_tap(torch, model) as r_cached:
                cached, cache = prefill_cache(model, tok, pos, seg, None)
            with router_tap(torch, model, r_cached or None):
                uncached = model(tok, pos, seg)
            prefill_err = rel_err(torch, cached[:, -1], uncached[:, -1])
            del uncached
            if r_cached:
                with router_tap(torch, model) as r_free:
                    free = model(tok, pos, seg)
                check["prefill_free_routing"] = moe_free_routing(
                    torch, cached[:, -1], free[:, -1], r_cached, r_free,
                    cfg.experts_per_token, real)
                del free
            # One decode step of row 0 against the uncached forward of
            # that row alone, unpadded.
            first = cached[:, -1].argmax(-1)
            ones = torch.ones(b, 1, dtype=torch.int32, device=dev)
            with router_tap(torch, model) as r_step:
                step = model(first[:, None], (p - pad)[:, None], ones,
                             cache=cache)[0, -1]
            row = torch.tensor([prompts[0] + [int(first[0])]], device=dev)
            n0 = len(prompts[0])
            # Row 0's routing: its prompt's in the cached prefill (the
            # last n0 positions, left-padded), then the step's.
            replay = [torch.cat([c[:1, p - n0:], st[:1]], 1)
                      for c, st in zip(r_cached, r_step)]
            with router_tap(torch, model, replay or None):
                step_err = rel_err(torch, step, model(row)[0, -1])
            if r_cached:
                with router_tap(torch, model) as r_free:
                    free = model(row)[0, -1]
                check["decode_step_row0_free_routing"] = moe_free_routing(
                    torch, step, free, replay, r_free, cfg.experts_per_token)
            del cache
            last_logits, real_logits = cached[:, -1], cached[real]
            del cached
        check.update({"prefill_last_position": prefill_err,
                      "decode_step_row0": step_err})
        r_fp32 = []
        fp32_logits = fp32_twin_logits(torch, model, tok, pos, seg,
                                       r_fp32)[real]
        if weights == "bf16":
            bf16_last, bf16_real, bf16_outs = last_logits, real_logits, outs
            bf16_fp32, bf16_r_fp32 = fp32_logits, r_fp32
        elif r_fp32:
            # MOE_CHECKS: the int8 run takes the bf16 run's routing.
            check["int8_vs_bf16_free_routing"] = moe_free_routing(
                torch, fp32_logits, bf16_fp32, r_fp32, bf16_r_fp32,
                cfg.experts_per_token, real)
            check["int8_vs_bf16_fp32_compute"] = rel_err(
                torch, fp32_twin_logits(torch, model, tok, pos, seg,
                                        replay=bf16_r_fp32)[real], bf16_fp32)
        else:
            check["int8_vs_bf16_fp32_compute"] = rel_err(
                torch, fp32_logits, bf16_fp32)
            check["int8_tol"] = INT8_TOL
            check["int8_vs_bf16_served_last_position"] = rel_err(
                torch, last_logits, bf16_last)
            check["int8_vs_bf16_served_every_position"] = rel_err(
                torch, real_logits, bf16_real)
            check["greedy_match_vs_bf16"] = sum(
                x == y for o, r in zip(outs, bf16_outs) for x, y in zip(o, r)
            ) / (len(outs) * max_new)
        emit(check)
        bad = [k for k in ("prefill_last_position", "decode_step_row0")
               if check[k][1] > SERVE_LOGITS_TOL]
        bad += [k for k in ("prefill_free_routing", "int8_vs_bf16_free_routing")
                if check.get(k, {}).get("topk_differ_share", 0) > MOE_FLIP_TOL]
        if weights == "int8" and (
                check["int8_vs_bf16_fp32_compute"][1] > INT8_TOL):
            bad.append("int8_vs_bf16_fp32_compute")
        if bad:
            raise AssertionError(f"serve ({weights}): {bad} past tolerance")

        # Bytes a decode step must read: every weight but the embedding
        # table (B rows are gathered; a tied table is read whole as the
        # head), plus the KV slots in use.
        weight_bytes = sum(t.numel() * t.element_size()
                           for n, t in model.named_parameters() if n != "embed")
        weight_bytes += (model.embed.numel() if model.lm_head is None
                         else b * cfg.d_model) * model.embed.element_size()
        bound_ms = (weight_bytes + kv_bytes) / chip.hbm_bw_bytes_per_s * 1e3
        emit({summary_key: {
            "model": family, "n_layers": cfg.n_layers,
            "weights": weights, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "generate_ms": total_ms,
            "tokens_per_s": b * max_new / (total_ms / 1e3),
            "decode_tokens_per_s": b / (decode_ms / 1e3),
            "weight_bytes_per_step": weight_bytes,
            "kv_bytes_per_step": kv_bytes,
            "hbm_bound_ms_per_step": bound_ms,
            "hbm_bound_share": bound_ms / decode_ms,
            "peak_mem_gb": peak_gb, "launches": launches,
            "device": kind, "nvidia_smi": smi,
        }})
        if weights == "bf16" and family == "llama3_8b":
            spec_batch_check(torch, model, prompts, max_new, outs, tok, pad,
                             kind, smi)
        if weights == "bf16" and after_bf16 is not None:
            after_bf16(model)


def spec_batch_check(torch, model, prompts, max_new, plain_outs, tok, pad,
                     kind, smi) -> None:
    """Phase 5's speculative run: ``run_batch``'s speculative path
    (``serve.speculative_batch``) on the serve slice's prompts with the
    target itself as the draft (a second cache, no second copy of the
    weights), SPEC_K drafts a pass, greedy. Holds full-length in-vocab
    outputs, no flash launch, and the verify block's logits (one pass of
    k+1 tokens) against k+1 teacher-forced single steps on a second
    cache, within SERVE_LOGITS_TOL; prints passes, accepted drafts per
    pass, wall, tokens/s and greedy agreement with the plain run."""
    from tpufw_torch.infer import SamplingConfig, prefill_cache
    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    b = len(prompts)
    flash.reset_launch_counts()
    res = {}

    def run():
        res["outs"], res["stats"] = serve.speculative_batch(
            model, model, prompts, max_new, SamplingConfig(), None, SPEC_K)

    wall_ms = host_ms(torch, run, 2)
    outs, stats = res["outs"], res["stats"]
    launches = dict(flash.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"serve (spec) launched {launches}")
    vocab = model.cfg.vocab_size
    for o in outs:
        if len(o) != max_new or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"serve (spec): bad output {o}")
    # The verify block: [first, t_1..t_k] of the plain greedy tokens in
    # one k+1 pass, against the same tokens fed one step at a time.
    p = tok.shape[1]
    col = torch.arange(p, device=tok.device)[None, :]
    seg = (col >= pad[:, None]).to(torch.int32)
    pos = torch.clamp(col - pad[:, None], min=0)
    block = torch.tensor([o[: SPEC_K + 1] for o in plain_outs],
                         device=tok.device)
    bpos = (p - pad)[:, None] + torch.arange(SPEC_K + 1,
                                             device=tok.device)[None, :]
    with torch.no_grad():
        _, cache = prefill_cache(model, tok, pos, seg, None)
        verify = model(block, bpos, torch.ones_like(block, dtype=torch.int32),
                       cache=cache).float()
        del cache
        _, cache = prefill_cache(model, tok, pos, seg, None)
        ones = torch.ones(b, 1, dtype=torch.int32, device=tok.device)
        steps = torch.cat([
            model(block[:, j:j + 1], bpos[:, j:j + 1], ones,
                  cache=cache).float() for j in range(SPEC_K + 1)], dim=1)
        del cache
    err = rel_err(torch, verify, steps)
    check = {"check": "serve_spec_verify_block_vs_single_steps",
             "logits": err, "tol": SERVE_LOGITS_TOL,
             "argmax_agreement": float(
                 (verify.argmax(-1) == steps.argmax(-1)).float().mean())}
    emit(check)
    if err[1] > SERVE_LOGITS_TOL:
        raise AssertionError(f"serve (spec): verify block {err}")
    passes = stats["iterations"]
    emit({"serve_spec_summary": {
        "k": SPEC_K, "draft": "target (self-draft)", "passes": passes,
        "tokens_per_pass": (stats["emitted"] - 1) / max(passes, 1),
        "accepted_drafts_per_pass": (stats["emitted"] - 1) / max(passes, 1)
        - 1,
        "generate_ms": wall_ms, "tokens_per_s": b * max_new / (wall_ms / 1e3),
        "greedy_match_vs_plain": sum(
            x == y for o, r in zip(outs, plain_outs) for x, y in zip(o, r)
        ) / (b * max_new),
        "launches": launches, "device": kind, "nvidia_smi": smi,
    }})


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _post(base, body):
    """Parsed JSON reply of ``POST /generate``."""
    import urllib.request

    req = urllib.request.Request(
        base + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _get(url):
    import urllib.request

    return urllib.request.urlopen(url, timeout=60)


def _stream(base, body):
    """(tokens of one row, seconds to the first token, seconds to done)
    of an SSE ``POST /generate``, timed on the client."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    toks, ttft = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[len(b"data: "):])
            if "error" in ev:
                raise AssertionError(f"stream error {ev['error']}")
            if ev.get("outputs") and ev["outputs"][0]:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.extend(ev["outputs"][0])
    return toks, ttft, time.perf_counter() - t0


def _concurrently(fns):
    """Run each function in its own thread, started in order; their
    results, in order. A failure in any is raised."""
    import threading

    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for th in threads:
        th.start()
        time.sleep(0.002)  # keep the arrival order
    for th in threads:
        th.join(timeout=600)
    if errs or any(th.is_alive() for th in threads):
        raise AssertionError(f"client failed: {errs or 'timed out'}")
    return out


def _admit_pool(model, prompts, kind, n_steps, cache_len=ONLINE_CACHE):
    """A pool of ONLINE_SLOTS rows at ``cache_len`` slots (``kind``:
    "contiguous", "paged" or "paged_int8") with ``prompts`` admitted in
    order, each prefilled at its exact width, ``n_steps`` of budget."""
    from tpufw_torch.infer import PagedSlotPool, SamplingConfig, SlotPool
    from tpufw_torch.infer import prefill_row

    if kind == "contiguous":
        pool = SlotPool.create(model, ONLINE_SLOTS, cache_len=cache_len)
    else:
        pool = PagedSlotPool.create_paged(
            model, ONLINE_SLOTS, cache_len=cache_len, page=ONLINE_PAGE,
            kv_quant="int8" if kind == "paged_int8" else "",
            sampling=SamplingConfig(), prefix_cache=False)
    for slot, p in enumerate(prompts):
        cache, _, first, _, _ = prefill_row(
            model, p, None, sampling=SamplingConfig(), eos_id=None,
            cache_len=cache_len)
        if kind == "contiguous":
            pool.insert(slot, cache, first, len(p), n_steps)
        else:
            ids, shared = pool.acquire_pages(p, len(p) + n_steps)
            pool.insert_paged(slot, cache, first, len(p), n_steps, ids,
                              shared)
    return pool


def _step_logits(torch, pool, tokens, j=0):
    """Logits [S, V] of feeding ``tokens`` [S] to every slot at its
    position + j (one decode step, advancing the pool's cache)."""
    ones = torch.ones(ONLINE_SLOTS, 1, dtype=torch.int32,
                      device=pool.token.device)
    return pool.model(tokens[:, None], (pool.pos + j)[:, None], ones,
                      cache=pool.cache)[:, -1].float()


def pool_run(torch, model, prompts, kind, n_steps, router=None,
             replay=None):
    """One admission sequence straight through a pool of ONLINE_SLOTS
    rows at ONLINE_CACHE slots (``kind``: "contiguous", "paged" or
    "paged_int8"), each prompt prefilled at its exact width: the first
    decode step's logits [rows, V] and ``n_steps`` greedy tokens per
    row. For a MoE model the step's router logits go to ``router``, a
    list, and ``replay`` routes the step with another run's
    (``router_tap``)."""
    with torch.no_grad():
        pool = _admit_pool(model, prompts, kind, n_steps)
        with router_tap(torch, model, replay) as rec:
            logits = _step_logits(torch, pool, pool.token)[: len(prompts)]
        if router is not None:
            router.extend(rec)
        del pool
        pool = _admit_pool(model, prompts, kind, n_steps)
        tokens = pool.decode_steps(n_steps)[: len(prompts)].tolist()
    return logits, tokens


def spec_pool_check(torch, model, prompts) -> dict:
    """Direct, contiguous and paged pools at ONLINE_SLOTS x ONLINE_CACHE:
    the verify block of a speculative pass (one forward of [token,
    t_1..t_k] over the pool's cache, as ``spec_steps`` runs it) against
    k+1 single steps teacher-forced with the same tokens on a second pool
    admitted alike, within SERVE_LOGITS_TOL (a MoE verify block with the
    single steps' routing, MOE_CHECKS, its free-routing error and flips
    printed); then ``spec_steps`` itself with those tokens as proposals,
    which must emit them."""
    n = len(prompts)
    n_moe = len(moe_routers(model))
    out = {}
    with torch.no_grad():
        for kind in ("contiguous", "paged"):
            pool = _admit_pool(model, prompts, kind, 2 * SPEC_K)
            tok, steps, fed = pool.token, [], []
            with router_tap(torch, model) as r_steps:
                for j in range(SPEC_K + 1):
                    fed.append(tok)
                    steps.append(_step_logits(torch, pool, tok, j))
                    tok = steps[-1].argmax(-1)
            steps = torch.stack(steps, dim=1)[:n]
            greedy = steps.argmax(-1)  # [n, k+1]
            # Each MoE layer's routing of the k+1 steps, as one block.
            replay = [torch.cat(r_steps[i::n_moe], dim=1)
                      for i in range(n_moe)]
            del pool
            block = torch.stack(fed, dim=1)
            verify = {}
            for how, rp in (("held", replay or None), ("free", None)):
                pool = _admit_pool(model, prompts, kind, 2 * SPEC_K)
                positions = pool.pos[:, None] + torch.arange(
                    SPEC_K + 1, device=block.device)[None, :]
                with router_tap(torch, model, rp) as r_verify:
                    verify[how] = model(
                        block, positions,
                        torch.ones_like(block, dtype=torch.int32),
                        cache=pool.cache)[:n].float()
                del pool
                if not replay:
                    break
            extra = {}
            if replay:
                extra["free_routing"] = moe_free_routing(
                    torch, verify["free"], steps,
                    [r[:n] for r in r_verify], [r[:n] for r in replay],
                    model.cfg.experts_per_token)
            verify = verify["held"]
            pool = _admit_pool(model, prompts, kind, 2 * SPEC_K)
            emitted, n_emit, accept = pool.spec_steps(
                torch.stack(fed[1:], dim=1))
            del pool
            out[kind] = {
                "logits": rel_err(torch, verify, steps),
                "argmax_agreement": float(
                    (verify.argmax(-1) == greedy).float().mean()),
                "spec_steps_accept": accept[:n].tolist(),
                "spec_steps_equal_single_steps": bool(
                    (emitted[:n] == greedy).all()),
            } | extra
    return out


def chunk_pool_check(torch, model, prompts, cache_len) -> dict:
    """Direct, paged pools at ONLINE_SLOTS x ``cache_len``, bf16 and int8
    KV: ``prompts`` prefilled monolithically and in chunks of
    ONLINE_CHUNK_PAGES pages; the first decode step's logits within
    SERVE_LOGITS_TOL, whether they are bit-equal, and the share of the
    prompts' K/V (int8: codes) that are equal."""
    from tpufw_torch.infer import PagedSlotPool, SamplingConfig, prefill_row

    n = len(prompts)
    out = {}
    with torch.no_grad():
        for kv in ("", "int8"):
            logits, kvs = {}, {}
            for how in ("monolithic", "chunked"):
                pool = PagedSlotPool.create_paged(
                    model, ONLINE_SLOTS, cache_len=cache_len,
                    page=ONLINE_PAGE, kv_quant=kv, sampling=SamplingConfig(),
                    prefix_cache=False)
                for slot, p in enumerate(prompts):
                    if how == "monolithic":
                        ids, shared = pool.acquire_pages(p, len(p) + 8)
                        cache, _, first, _, _ = prefill_row(
                            model, p, None, sampling=SamplingConfig(),
                            eos_id=None, cache_len=cache_len)
                        pool.insert_paged(slot, cache, first, len(p), 8, ids,
                                          shared)
                        del cache
                    else:
                        cp = pool.start_chunked(p, len(p) + 8, None,
                                                ONLINE_CHUNK_PAGES)
                        while pool.chunk_step(cp) != "done":
                            pass
                        pool.finalize_chunked(slot, cp, 8)
                # Every prompt slot of every row, in slot order.
                kvs[how] = torch.cat([
                    torch.stack([c.key[c.table[i]].flatten(0, 1)[:len(p)]
                                 for c in pool.cache]).flatten()
                    for i, p in enumerate(prompts)])
                logits[how] = _step_logits(torch, pool, pool.token)[:n]
                del pool
            err = rel_err(torch, logits["chunked"], logits["monolithic"])
            out[kv or "bf16"] = {
                "logits": err,
                "logits_bit_equal": bool(torch.equal(logits["chunked"],
                                                     logits["monolithic"])),
                "kv_equal_share": float(
                    (kvs["chunked"] == kvs["monolithic"]).float().mean()),
                "greedy_agreement": float(
                    (logits["chunked"].argmax(-1)
                     == logits["monolithic"].argmax(-1)).float().mean()),
            }
    return out


def online_phase(torch, kind, smi) -> None:
    """Phase 6: the HTTP server on Llama-3-8B (ONLINE_LAYERS layers, bf16
    weights, 8 slots, greedy) on one set of weights: the slot scheduler's
    modes, then the tick batcher (``tick_mode``) and the spill tier
    (``spill_mode``, bf16 and int8 KV); raises AssertionError on a failed
    check."""
    import numpy as np

    from tpufw_torch.configs import llama3_8b_serve_slice
    from tpufw_torch.models import Llama
    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    cfg = dataclasses.replace(llama3_8b_serve_slice()[0],
                              n_layers=ONLINE_LAYERS)
    rng = np.random.default_rng(0)
    by_len = {n: [rng.integers(1, cfg.vocab_size, n).tolist()
                  for _ in range(4)] for n in ONLINE_PROMPT_LENS}
    # Interleaved longest first: the first arrival keys a pool every
    # later request fits.
    prompts = [by_len[n][i] for i in range(4)
               for n in reversed(ONLINE_PROMPT_LENS)]
    shared = rng.integers(1, cfg.vocab_size, ONLINE_PREFIX).tolist()
    prefixed = [shared + rng.integers(1, cfg.vocab_size, n).tolist()
                for n in (16, 24, 40, 56)]
    direct = [by_len[n][0] for n in ONLINE_PROMPT_LENS]
    emit({"online": "llama3_8b", "n_layers": cfg.n_layers,
          "params": cfg.n_params(), "param_dtype": "bfloat16",
          "max_seq_len": cfg.max_seq_len, "slots": ONLINE_SLOTS,
          "prompt_lens": [len(p) for p in prompts],
          "prefix_prompt_lens": [len(p) for p in prefixed],
          "shared_prefix": ONLINE_PREFIX, "max_new_tokens": ONLINE_NEW,
          "page": ONLINE_PAGE, "sampling": "greedy"})
    selfsim = [(rng.integers(1, cfg.vocab_size, SELFSIM_PATTERN).tolist()
                * (SELFSIM_LEN // SELFSIM_PATTERN)) for _ in range(4)]
    hol_long = rng.integers(1, cfg.vocab_size, HOL_LONG).tolist()
    emit({"online_added": {"chunk_pages": ONLINE_CHUNK_PAGES,
                           "hol_pair": [HOL_LONG, 7], "hol_gap_s": HOL_GAP_S,
                           "selfsim_prompt_lens": [len(p) for p in selfsim],
                           "spec_k": SPEC_K}})
    model = Llama(cfg, device="cuda", seed=0)
    page = {"TPUFW_SERVE_PAGE": str(ONLINE_PAGE)}
    # (mode, env, draft model, extra wave after the 16 requests)
    modes = (("contiguous", {}, None, None),
             ("paged_bf16", page, None, prefixed),
             ("paged_int8", dict(page, TPUFW_SERVE_KV_QUANT="int8"), None,
              prefixed),
             ("paged_chunked", dict(page, TPUFW_SERVE_PREFILL_CHUNK=str(
                 ONLINE_CHUNK_PAGES)), None, prefixed),
             ("spec_ngram", dict(page, TPUFW_SERVE_SPEC_K=str(SPEC_K)), None,
              selfsim),
             ("spec_draft", dict(page, TPUFW_DRAFT_K=str(SPEC_K)), model,
              None))
    bf16_paged_logits = bf16_paged_tokens = None
    paged_outputs = None  # paged_bf16's tokens of the 16 requests
    for mode, env, draft, wave in modes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launch_counts()
        srv, base = _start_server(serve, env, model=model, draft_model=draft)
        sched = srv._batcher
        # Decode and speculative time of the warm-up request, left out
        # of the summary.
        warm_s, warm_steps = sched.decode_s, sched.decode_steps_run
        warm_spec = (sched.spec_s, sched.spec_passes, sched.spec_tokens)
        try:
            sent = []  # max_new of every /generate request
            t0 = time.perf_counter()
            traffic = prompts + (wave or [])
            runs = _concurrently([
                (lambda p=p: _stream(base, {"prompts": [p],
                                            "max_new_tokens": ONLINE_NEW}))
                for p in prompts])
            if wave:
                # After the first wave: the prefix requests share one
                # pool's trie, the self-similar ones a pool of their own.
                runs += _concurrently([
                    (lambda p=p: _stream(base, {"prompts": [p],
                                                "max_new_tokens": ONLINE_NEW}))
                    for p in wave])
            wall = time.perf_counter() - t0
            sent += [ONLINE_NEW] * len(traffic)
            for toks, _, _ in runs:
                if len(toks) != ONLINE_NEW or not all(
                        0 <= t < cfg.vocab_size for t in toks):
                    raise AssertionError(f"{mode}: bad output {toks}")
            check = {"check": f"online_{mode}"}
            if mode == "contiguous":
                # Liveness: a short request sent after a long one
                # completes first; an SSE and a JSON request for one
                # prompt, decoded side by side, agree.
                long_p, short_p = by_len[511][1], by_len[7][1]
                long_t = [None]

                def long_req():
                    out = _post(base, {"prompts": [long_p],
                                       "max_new_tokens": ONLINE_LONG_NEW})
                    long_t[0] = time.perf_counter()
                    return out["outputs"][0]

                def wait_for_long():
                    deadline = time.perf_counter() + 120
                    while not sched.slots_occupied:
                        if time.perf_counter() > deadline:
                            raise AssertionError("the long request never "
                                                 "took a slot")
                        time.sleep(0.005)

                def short_req():
                    wait_for_long()
                    out = _post(base, {"prompts": [short_p],
                                       "max_new_tokens": 8})
                    return out["outputs"][0], time.perf_counter()

                def pair_req(stream):
                    wait_for_long()
                    body = {"prompts": [direct[1]],
                            "max_new_tokens": ONLINE_NEW}
                    if stream:
                        return _stream(base, body)[0]
                    return _post(base, body)["outputs"][0]

                long_out, (short_out, short_t), sse, js = _concurrently([
                    long_req, short_req, lambda: pair_req(True),
                    lambda: pair_req(False)])
                sent += [ONLINE_LONG_NEW, 8, ONLINE_NEW, ONLINE_NEW]
                check["short_before_long_s"] = long_t[0] - short_t
                check["sse_equals_json"] = sse == js
                if not (long_t[0] > short_t and len(long_out) ==
                        ONLINE_LONG_NEW and len(short_out) == 8):
                    raise AssertionError(f"{mode}: liveness {check}")
                if sse != js:
                    raise AssertionError(f"{mode}: SSE {sse} != JSON {js}")
            hol = None
            if mode in ("paged_bf16", "paged_chunked"):
                # The head-of-line pair: held with chunked prefill,
                # measured for comparison without it.
                def timed(p, n, gap):
                    time.sleep(gap)
                    t_sent = time.perf_counter()
                    toks, ttft, _ = _stream(base, {"prompts": [p],
                                                   "max_new_tokens": n})
                    return toks, t_sent, t_sent + ttft

                (l_toks, l_sent, l_first), (s_toks, s_sent, s_first) = (
                    _concurrently([lambda: timed(hol_long, ONLINE_NEW, 0.0),
                                   lambda: timed(by_len[7][2], 8,
                                                 HOL_GAP_S)]))
                sent += [ONLINE_NEW, 8]
                hol = {"long_ttft_ms": (l_first - l_sent) * 1e3,
                       "short_ttft_ms": (s_first - s_sent) * 1e3,
                       "short_first_token_before_long_s": l_first - s_first}
                check["hol_pair"] = hol
                if len(l_toks) != ONLINE_NEW or len(s_toks) != 8:
                    raise AssertionError(f"{mode}: HOL pair outputs")
                if mode == "paged_chunked" and not s_first < l_first:
                    raise AssertionError(f"{mode}: HOL {hol}")
            with _get(base + "/healthz") as r:
                if json.loads(r.read())["ok"] is not True:
                    raise AssertionError(f"{mode}: /healthz not ok")
            metrics = _metrics(base)
            launches = dict(flash.LAUNCHES)
            check.update({
                "requests": [metrics["tpufw_serve_requests_total"],
                             len(sent)],
                "tokens": [metrics["tpufw_serve_tokens_generated_total"],
                           sum(sent)],
                "errors": metrics["tpufw_serve_request_errors_total"],
                "slots_occupied_after": metrics[
                    "tpufw_serve_slots_occupied"],
                "flash_launches": launches,
            })
            bad = [k for k in ("requests", "tokens")
                   if check[k][0] != check[k][1]]
            if check["errors"] or check["slots_occupied_after"]:
                bad.append("errors or slots")
            if any(launches.values()):
                bad.append("flash launched")
            if mode != "contiguous":
                check["pages_in_use_after"] = sched.pages_in_use
                check["trie_pages"] = len(sched.pool.prefix)
                # With a draft pool this is also its leak check: its
                # pages come from the target's allocator.
                if check["pages_in_use_after"] != check["trie_pages"]:
                    bad.append("pages in use beside the trie's")
            if wave is prefixed:
                check["prefix_hits"] = metrics[
                    "tpufw_serve_prefix_hits_total"]
                # Chunked admissions of one pass all open before any
                # chunk is checkpointed, so a burst may share nothing.
                if check["prefix_hits"] <= 0 and mode != "paged_chunked":
                    bad.append("no prefix hit")
            ttft = [r[1] * 1e3 for r in runs]
            steps = sched.decode_steps_run - warm_steps
            summary = {
                "mode": mode, "wall_s": wall, "requests": len(traffic),
                "output_tokens": ONLINE_NEW * len(traffic),
                "tokens_per_s": ONLINE_NEW * len(traffic) / wall,
                "ttft_ms_p50": _percentile(ttft, 0.5),
                "ttft_ms_p95": _percentile(ttft, 0.95),
                "ttft_ms_sorted": [round(t) for t in sorted(ttft)],
                "latency_ms_p50": _percentile([r[2] * 1e3 for r in runs],
                                              0.5),
                "decode_ms_per_step": ((sched.decode_s - warm_s) / steps
                                       * 1e3 if steps else None),
                "decode_steps": steps,
                "pool_switches": metrics["tpufw_serve_pool_switches_total"],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_pages_in_use": sched.peak_pages_in_use,
                "pages_total": sched.pages_total,
                "device": kind, "nvidia_smi": smi,
            }
            if hol is not None:
                summary["hol_pair"] = hol
            if "tpufw_prefill_chunks_total" in metrics:
                summary["prefill_chunks"] = metrics[
                    "tpufw_prefill_chunks_total"]
            if mode == "paged_bf16":
                paged_outputs = [r[0] for r in runs[: len(prompts)]]
            if mode.startswith("spec"):
                passes = sched.spec_passes - warm_spec[1]
                rate = metrics["tpufw_spec_accept_rate"]
                summary.update({
                    "spec_k": SPEC_K, "spec_passes": passes,
                    "spec_ms_per_pass": ((sched.spec_s - warm_spec[0])
                                         / passes * 1e3 if passes else None),
                    "spec_tokens_per_pass": ((sched.spec_tokens
                                              - warm_spec[2]) / passes
                                             if passes else None),
                    "accept_rate": rate,
                    "accepted_drafts_per_slot_pass": rate * SPEC_K,
                    "fallback_slots": metrics["tpufw_spec_fallback_slots"],
                    "wasted_draft_flops": metrics[
                        "tpufw_spec_wasted_draft_flops_total"],
                    "greedy_match_vs_paged_bf16": sum(
                        x == y for r, o in zip(runs, paged_outputs)
                        for x, y in zip(r[0], o)) / (len(prompts)
                                                     * ONLINE_NEW),
                })
                if passes <= 0:
                    bad.append("no speculative pass")
        finally:
            srv.shutdown()
        if mode in ("paged_bf16", "paged_int8"):
            # One admission sequence straight through the pools.
            logits, tokens = pool_run(
                torch, model, direct,
                "paged_int8" if mode == "paged_int8" else "paged", 32)
            if mode == "paged_bf16":
                ref_logits, ref_tokens = pool_run(torch, model, direct,
                                                  "contiguous", 32)
                err, tol, vs = rel_err(torch, logits, ref_logits), \
                    SERVE_LOGITS_TOL, "contiguous"
                bf16_paged_logits, bf16_paged_tokens = logits, tokens
            else:
                ref_tokens = bf16_paged_tokens
                err, tol, vs = rel_err(torch, logits, bf16_paged_logits), \
                    INT8_TOL, "paged_bf16"
            check["step_logits_vs_" + vs] = err
            check["tol"] = tol
            check["greedy_match_vs_" + vs] = sum(
                x == y for o, r in zip(tokens, ref_tokens)
                for x, y in zip(o, r)) / (len(tokens) * 32)
            if err[1] > tol:
                bad.append("step logits past tolerance")
        if mode == "paged_chunked":
            chunk = chunk_pool_check(torch, model, direct + [hol_long],
                                     ONLINE_MAX_CACHE)
            check["chunked_vs_monolithic"] = chunk
            check["tol"] = SERVE_LOGITS_TOL
            if any(v["logits"][1] > SERVE_LOGITS_TOL for v in chunk.values()):
                bad.append("chunked logits past tolerance")
        if mode == "spec_draft":
            spec = spec_pool_check(torch, model, direct)
            check["verify_block_vs_single_steps"] = spec
            check["tol"] = SERVE_LOGITS_TOL
            if any(v["logits"][1] > SERVE_LOGITS_TOL for v in spec.values()):
                bad.append("verify block logits past tolerance")
        emit(check)
        emit({"online_summary": summary})
        if bad:
            raise AssertionError(f"online {mode}: {bad}")
    tick_mode(torch, model, prompts, direct, kind, smi)
    shared_prompts = [shared + rng.integers(1, cfg.vocab_size, n).tolist()
                      for n in (16, 40)]
    for kv in ("", "int8"):
        spill_mode(torch, model, shared, shared_prompts, kv, kind, smi)
    for k in [k for k in os.environ if k.startswith("TPUFW_")]:
        del os.environ[k]


def _start_server(serve, env, **kw):
    """A ``_Server`` on a free localhost port with exactly the TPUFW_*
    environment ``env``; (server, base URL)."""
    import threading

    for k in [k for k in os.environ if k.startswith("TPUFW_")]:
        del os.environ[k]
    os.environ.update(env)
    srv = serve._Server(0, 8, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    while srv.httpd is None:
        time.sleep(0.01)
    return srv, f"http://127.0.0.1:{srv.port}"


def _metrics(base) -> dict:
    with _get(base + "/metrics") as r:
        return {ln.split()[0]: float(ln.split()[1])
                for ln in r.read().decode().splitlines()
                if ln and not ln.startswith("#")}


def tick_mode(torch, model, prompts, direct, kind, smi) -> None:
    """Phase 6's ``tick`` mode: the tick batcher (TPUFW_SERVE_SLOTS=0) on
    the same weights. The 16 prompts as concurrent SSE clients (each
    stream a tick of its own), then as concurrent JSON clients (coalesced
    into ticks of up to 64 rows). Holds full-length in-vocab outputs, the
    /metrics counts, no flash launch, and the four direct prompts' greedy
    tokens equal to ``generate_text`` on the rows and cache length their
    ticks ran (the prompt and the length-bucket filler row)."""
    from tpufw_torch.infer import generate_text
    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    srv, base = _start_server(serve, {"TPUFW_SERVE_SLOTS": "0"}, model=model)
    vocab = model.cfg.vocab_size
    try:
        t0 = time.perf_counter()
        runs = _concurrently([
            (lambda p=p: _stream(base, {"prompts": [p],
                                        "max_new_tokens": ONLINE_NEW}))
            for p in prompts])
        sse_wall = time.perf_counter() - t0
        ticks0 = _metrics(base)["tpufw_serve_ticks_total"]
        t0 = time.perf_counter()
        json_runs = _concurrently([
            (lambda p=p: _post(base, {"prompts": [p],
                                      "max_new_tokens": ONLINE_NEW}))
            for p in prompts])
        json_wall = time.perf_counter() - t0
        metrics = _metrics(base)
        launches = dict(flash.LAUNCHES)
    finally:
        srv.shutdown()
    outs = [r[0] for r in runs] + [r["outputs"][0] for r in json_runs]
    bad = []
    if not all(len(o) == ONLINE_NEW and all(0 <= t < vocab for t in o)
               for o in outs):
        bad.append("bad output")
    n_req = 2 * len(prompts)
    check = {"check": "online_tick",
             "requests": [metrics["tpufw_serve_requests_total"], n_req],
             "tokens": [metrics["tpufw_serve_tokens_generated_total"],
                        n_req * ONLINE_NEW],
             "errors": metrics["tpufw_serve_request_errors_total"],
             "flash_launches": launches}
    if any(check[k][0] != check[k][1] for k in ("requests", "tokens")):
        bad.append("counts")
    if check["errors"] or any(launches.values()):
        bad.append("errors or flash launched")
    # The direct prompts' streams, against generate_text on their ticks'
    # rows: [prompt, length-bucket filler], the tick's cache length.
    want = []
    for p in direct:
        longest = serve._bucket(len(p), 64)
        want += generate_text(
            model, [p, [0] * longest], max_new_tokens=ONLINE_NEW,
            live_rows=[True, False],
            cache_len=serve._cache_bucket(longest + ONLINE_NEW,
                                          model.cfg.max_seq_len))[:1]
    got = [runs[prompts.index(p)][0] for p in direct]
    check["direct_equal_generate"] = got == want
    check["sse_vs_json_greedy_match"] = sum(
        x == y for r, j in zip(runs, json_runs)
        for x, y in zip(r[0], j["outputs"][0])) / (len(prompts) * ONLINE_NEW)
    if got != want:
        bad.append("direct prompts differ from generate")
    ttft = [r[1] * 1e3 for r in runs]
    # A stream's chunks arrive every TPUFW_STREAM_CHUNK (16) steps: its
    # decode steps after the first chunk, over the time between them.
    per_step = [(r[2] - r[1]) / (ONLINE_NEW - 16) * 1e3 for r in runs]
    ticks = metrics["tpufw_serve_ticks_total"] - ticks0
    emit(check)
    emit({"online_summary": {
        "mode": "tick", "sse_wall_s": sse_wall, "json_wall_s": json_wall,
        "tokens_per_s_sse": ONLINE_NEW * len(prompts) / sse_wall,
        "tokens_per_s_json": ONLINE_NEW * len(prompts) / json_wall,
        "ttft_ms_p50": _percentile(ttft, 0.5),
        "ttft_ms_p95": _percentile(ttft, 0.95),
        "decode_ms_per_step_solo_stream_p50": _percentile(per_step, 0.5),
        "json_ticks": ticks,
        "json_batched_with": sorted({r["batched_with"] for r in json_runs}),
        "json_ms_per_tick_step": json_wall / max(ticks, 1) / ONLINE_NEW * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": kind, "nvidia_smi": smi}})
    if bad:
        raise AssertionError(f"online tick: {bad}")


def spill_pool_check(torch, model, shared, prompts, kv) -> dict:
    """Direct, one paged pool at ONLINE_SLOTS x ONLINE_CACHE with the
    spill tier: ``prompts[0]`` registers ``shared``'s pages in the trie;
    they are evicted through the spill hook (timed); ``prompts[1]``
    restores them at admission (timed, through the host tier and the
    device scatter). The restored pages must be bit-equal to the evicted
    ones, and the restored admission's first-step logits within
    SERVE_LOGITS_TOL of a cold prefill's of the same prompt."""
    from tpufw_torch.infer import PagedSlotPool, SamplingConfig, prefill_row
    from tpufw_torch.infer.spill import SpillTier
    from tpufw_torch.serve.bundle import attach_spill

    greedy = SamplingConfig()

    def pool_of(prefix):
        return PagedSlotPool.create_paged(
            model, ONLINE_SLOTS, cache_len=ONLINE_CACHE, page=ONLINE_PAGE,
            kv_quant=kv, sampling=greedy, prefix_cache=prefix)

    def admit(pool, p, ids=None, shared_n=0):
        if ids is None:
            ids, shared_n = pool.acquire_pages(p, len(p) + 8)
        if shared_n:
            cache, _, first, _, _ = pool.prefill_shared(p, ids[:shared_n],
                                                        None)
        else:
            cache, _, first, _, _ = prefill_row(
                model, p, None, sampling=greedy, eos_id=None,
                cache_len=ONLINE_CACHE)
        pool.insert_paged(0, cache, first, len(p), 8, ids, shared_n)
        pool.register_prefix(p, ids)
        return _step_logits(torch, pool, pool.token)[0]

    n = len(shared) // ONLINE_PAGE
    with torch.no_grad():
        tier = SpillTier(64)
        pool = pool_of(True)
        attach_spill(pool, tier)
        admit(pool, prompts[0])
        pool.release_slot(0)
        before = pool.export_pages_state(pool.prefix.match(shared))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.prefix.evict(n, pool.allocator, on_evict=pool._spill_hook())
        spill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, shared_n = pool.acquire_pages(prompts[1], len(prompts[1]) + 8)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = admit(pool, prompts[1], ids, shared_n)
        after = pool.export_pages_state(pool.prefix.match(shared))
        spilled_bytes = tier.spilled_bytes_total
        del pool
        cold = admit(pool_of(False), prompts[1])
    equal = before["paths"] == after["paths"] and all(
        a.tobytes() == b.tobytes()
        for a, b in zip(before["arrays"], after["arrays"]))
    return {"pages": n, "shared_pages_restored": shared_n,
            "pages_bit_equal": equal,
            "spill_ms_per_page": spill_s / n * 1e3,
            "restore_ms_per_page": restore_s / n * 1e3,
            "bundle_bytes_per_page": spilled_bytes / n,
            "first_step_logits_vs_cold": rel_err(torch, restored, cold),
            "greedy_equal_cold": bool(restored.argmax() == cold.argmax())}


def spill_mode(torch, model, shared, shared_prompts, kv, kind, smi) -> None:
    """Phase 6's ``paged_spill`` mode (``kv`` "" or "int8"): the slot
    scheduler, paged, with the spill tier (TPUFW_KV_SPILL) and an arena of
    SPILL_ARENA_PAGES pages, one pool (TPUFW_SERVE_CACHE_FLOOR=2048 keys
    every request to the same cache rung). A request holding the
    ONLINE_PREFIX-token prefix leaves its 7 pages in the trie; 8
    concurrent short requests need more pages than are free, so those 7
    are evicted into the tier; a request sharing the prefix restores them.
    Holds spill_pages_out and spill_pages_in of 7, the restored pages
    bit-equal to the evicted ones, full-length in-vocab outputs, the
    /metrics counts and spill series, no flash launch; then
    ``spill_pool_check``."""
    import numpy as np

    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    mode = "paged_spill" + ("_int8" if kv else "")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    env = {"TPUFW_SERVE_PAGE": str(ONLINE_PAGE), "TPUFW_KV_SPILL": "64",
           "TPUFW_SERVE_CACHE_FLOOR": "2048", "TPUFW_WARMUP": "0",
           "TPUFW_SERVE_KV_QUANT": kv}
    srv, base = _start_server(serve, env, model=model)
    sched = srv._batcher
    # Pools are built at the first admission: set the arena before it.
    sched.arena_pages = SPILL_ARENA_PAGES
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(5)
    shorts = [rng.integers(1, vocab, 7).tolist() for _ in range(8)]
    n_pages = len(shared) // ONLINE_PAGE
    try:
        t0 = time.perf_counter()
        outs = [_post(base, {"prompts": [shared_prompts[0]],
                             "max_new_tokens": ONLINE_NEW})["outputs"][0]]
        pool = sched.pool
        before = pool.export_pages_state(pool.prefix.match(shared))
        outs += [r["outputs"][0] for r in _concurrently([
            (lambda p=p: _post(base, {"prompts": [p],
                                      "max_new_tokens": ONLINE_NEW}))
            for p in shorts])]
        spilled_out = pool.spill_pages_out
        t_restore = time.perf_counter()
        outs.append(_post(base, {"prompts": [shared_prompts[1]],
                                 "max_new_tokens": ONLINE_NEW})["outputs"][0])
        restore_req_s = time.perf_counter() - t_restore
        wall = time.perf_counter() - t0
        after = pool.export_pages_state(pool.prefix.match(shared))
        metrics = _metrics(base)
        launches = dict(flash.LAUNCHES)
        same_pool = sched.pool is pool
        counters = (pool.spill_pages_out, pool.spill_pages_in,
                    pool.prefix_hits)
    finally:
        srv.shutdown()
    n_req = len(outs)
    check = {
        "check": f"online_{mode}", "arena_pages": SPILL_ARENA_PAGES,
        "spill_pages_out": counters[0], "spill_pages_in": counters[1],
        "spill_pages_out_before_restore": spilled_out,
        "prefix_hits": counters[2], "one_pool": same_pool,
        "restored_pages_bit_equal": before["paths"] == after["paths"] and all(
            a.tobytes() == b.tobytes()
            for a, b in zip(before["arrays"], after["arrays"])),
        "requests": [metrics["tpufw_serve_requests_total"], n_req],
        "tokens": [metrics["tpufw_serve_tokens_generated_total"],
                   n_req * ONLINE_NEW],
        "errors": metrics["tpufw_serve_request_errors_total"],
        "kv_spill_bytes_total": metrics["tpufw_kv_spill_bytes_total"],
        "kv_spill_pages_ram": metrics['tpufw_kv_spill_pages{tier="ram"}'],
        "kv_restore_count": metrics["tpufw_kv_restore_seconds_count"],
        "kv_restore_host_ms_per_page": (
            metrics["tpufw_kv_restore_seconds_sum"] * 1e3
            / max(metrics["tpufw_kv_restore_seconds_count"], 1)),
        "flash_launches": launches,
    }
    bad = []
    if not all(len(o) == ONLINE_NEW and all(0 <= t < vocab for t in o)
               for o in outs):
        bad.append("bad output")
    if any(check[k][0] != check[k][1] for k in ("requests", "tokens")):
        bad.append("counts")
    if check["errors"] or any(launches.values()):
        bad.append("errors or flash launched")
    if not (same_pool and spilled_out == n_pages
            and counters[1] == n_pages and counters[2] >= 1):
        bad.append("spill or restore")
    if not check["restored_pages_bit_equal"]:
        bad.append("restored pages differ from the evicted ones")
    if not (check["kv_spill_bytes_total"] > 0
            and check["kv_restore_count"] == n_pages):
        bad.append("spill series")
    direct = spill_pool_check(torch, model, shared, shared_prompts, kv)
    check["direct"] = direct
    check["tol"] = SERVE_LOGITS_TOL
    if not (direct["pages_bit_equal"]
            and direct["shared_pages_restored"] == n_pages
            and direct["first_step_logits_vs_cold"][1] <= SERVE_LOGITS_TOL):
        bad.append("direct spill check")
    emit(check)
    emit({"online_summary": {
        "mode": mode, "wall_s": wall, "requests": n_req,
        "restoring_request_s": restore_req_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": kind, "nvidia_smi": smi}})
    if bad:
        raise AssertionError(f"online {mode}: {bad}")


class _Env:
    """Set TPUFW_* variables for a block, restoring the old values."""

    def __init__(self, **env):
        self.env = {f"TPUFW_{k.upper()}": str(v) for k, v in env.items()}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _RssPeak:
    """Peak VmRSS, and RssAnon and RssFile where the kernel reports them
    (GB, from /proc/self/status), over a block, sampled every 20 ms by a
    thread, and the values at its start."""

    def __enter__(self):
        import threading

        self.start = self.peak = self._read()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _read(self) -> dict:
        out = {}
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith(("VmRSS:", "RssAnon:", "RssFile:")):
                    out[ln.split(":")[0]] = int(ln.split()[1]) * 1024 / 1e9
        return out

    def _run(self):
        while not self._stop.wait(0.02):
            now = self._read()
            self.peak = {k: max(v, now[k]) for k, v in self.peak.items()}

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()


def make_corpus(workdir: str, seed: int = 0) -> tuple[str, dict]:
    """Phase 7a's corpus: about CORPUS_TOKENS bytes of lines of random
    lowercase words (numpy ``seed``), one document per line, packed with
    the byte tokenizer. Returns (prefix, pack_corpus stats)."""
    import numpy as np

    from tpufw_torch.tools.pack_corpus import pack_corpus

    rng = np.random.default_rng(seed)
    letters = rng.integers(ord("a"), ord("z") + 1, CORPUS_TOKENS,
                           dtype=np.uint8)
    # Spaces between words of mean 6 letters, newlines between documents
    # of mean 2,000 bytes.
    letters[rng.random(CORPUS_TOKENS) < 1 / 6] = ord(" ")
    letters[rng.random(CORPUS_TOKENS) < 1 / 2000] = ord("\n")
    txt = os.path.join(workdir, "corpus.txt")
    with open(txt, "wb") as f:
        f.write(letters.tobytes())
    prefix = os.path.join(workdir, "corpus")
    stats = pack_corpus([txt], prefix, per_line=True)
    os.remove(txt)
    return prefix, stats


def corpus_phase(torch, prefix: str) -> dict:
    """7a: the native packer built by ``ops/_build.py``, its first
    PARITY_BATCHES batches (no shuffle) bit-equal to the Python packer's,
    and prefetch_to_device's CUDA batches equal to the host batches.
    Returns the numbers of the data_summary line."""
    import itertools

    import numpy as np

    from tpufw_torch.train import TokenCorpus, prefetch_to_device

    t0 = time.perf_counter()
    native = TokenCorpus(prefix, RESUME_BATCH, RESUME_SEQ)
    lib_s = time.perf_counter() - t0
    if not native.native:
        raise AssertionError("TokenCorpus did not load the native packer")
    python = TokenCorpus(prefix, RESUME_BATCH, RESUME_SEQ, native=False)
    got = list(itertools.islice(native, PARITY_BATCHES))
    want = list(itertools.islice(python, PARITY_BATCHES))
    equal = len(got) == len(want) == PARITY_BATCHES and all(
        g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)
        for g, w in zip(got, want))
    fetched = list(prefetch_to_device(iter(got), "cuda"))
    torch.cuda.synchronize()
    on_card = all(v.is_cuda for b in fetched for v in b.values())
    prefetch_equal = len(fetched) == len(got) and all(
        np.array_equal(f[k].cpu().numpy(), g[k])
        for f, g in zip(fetched, got) for k in g)
    emit({"check": "native_vs_python_packer", "batches": PARITY_BATCHES,
          "bit_equal": equal, "prefetch_on_cuda": on_card,
          "prefetch_equal": prefetch_equal})
    if not (equal and on_card and prefetch_equal):
        raise AssertionError("7a: packer parity or prefetch failed")
    n = 256
    t0 = time.perf_counter()
    for _ in itertools.islice(iter(TokenCorpus(prefix, RESUME_BATCH,
                                               RESUME_SEQ, shuffle=True)), n):
        pass
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in itertools.islice(iter(python), n // 8):
        pass
    python_s = time.perf_counter() - t0
    return {"native_batches_per_s": n / native_s,
            "native_host_ms_per_batch": 1e3 * native_s / n,
            "python_host_ms_per_batch": 1e3 * python_s / (n // 8),
            "library_load_or_build_s": lib_s,
            "batch": RESUME_BATCH, "seq_len": RESUME_SEQ}


def _corpus_batches(torch, prefix, skip=0):
    """The 7b train stream: the corpus shuffled (seed 0) from batch
    ``skip`` on, through prefetch_to_device."""
    import itertools

    from tpufw_torch.train import TokenCorpus, prefetch_to_device

    corpus = TokenCorpus(prefix, RESUME_BATCH, RESUME_SEQ, shuffle=True)
    return prefetch_to_device(itertools.islice(iter(corpus), skip, None),
                              "cuda")


def resume_phase(torch, prefix: str, workdir: str, kind, smi) -> dict:
    """7b: llama3_600m_bench through Trainer.run for RESUME_STEPS steps on
    the 7a corpus, checkpointing every RESUME_EVERY steps, launch counters
    zeroed just before; then a fresh trainer restores step RESUME_EVERY
    and trains the rest on the same batches. Holds the restored tensors'
    checksums equal to those taken when the step was saved, the losses
    after the restore and the final parameters bit-equal to the first
    run's, and every head-dim-128 kernel launched. Returns the first run's
    launch counts and its median step ms."""
    from tpufw_torch.configs import bench_model_config
    from tpufw_torch.ops import flash
    from tpufw_torch.train import Trainer, TrainerConfig
    from tpufw_torch.train.checkpoint import CheckpointManager, checksums

    cfg = bench_model_config()
    ckpt_dir = os.path.join(workdir, "ckpt")
    tcfg = TrainerConfig(batch_size=RESUME_BATCH, seq_len=RESUME_SEQ,
                         total_steps=RESUME_STEPS, warmup_steps=2,
                         log_every=1, loss_chunk_size=512,
                         checkpoint_dir=ckpt_dir,
                         checkpoint_every=RESUME_EVERY)
    emit({"train": "llama3_600m_bench resume", "params": cfg.n_params(),
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "batch_size": RESUME_BATCH, "seq_len": RESUME_SEQ,
          "remat_policy": cfg.remat_policy, "steps": RESUME_STEPS,
          "checkpoint_every": RESUME_EVERY})
    first = Trainer(cfg, tcfg, device="cuda")
    first.init_state(seed=0)
    saved_sums = {}

    def on_metrics(m):
        emit({"resume_run1_step": m.as_dict()})
        if m.step == RESUME_EVERY:
            # What the loop saves right after this call.
            saved_sums.update(checksums(first.state_dict()))

    torch.cuda.synchronize()
    flash.reset_launch_counts()
    h1 = first.run(_corpus_batches(torch, prefix),
                   model_flops_per_token=cfg.flops_per_token(RESUME_SEQ - 1),
                   on_metrics=on_metrics)
    torch.cuda.synchronize()
    launches = {k: flash.LAUNCHES[flash.kernel_name(k, 128)]
                for k in flash.KERNELS}
    saves = first.checkpointer.saves
    mgr = CheckpointManager(ckpt_dir)
    if mgr.all_steps() != [RESUME_EVERY, RESUME_STEPS]:
        raise AssertionError(f"7b: checkpoints {mgr.all_steps()}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mgr.restore(RESUME_EVERY, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_sums = checksums(state)
    second = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=None),
                     device="cuda")
    second.load_state_dict(state)
    del state
    flash.reset_launch_counts()
    h2 = second.run(_corpus_batches(torch, prefix, skip=RESUME_EVERY),
                    model_flops_per_token=cfg.flops_per_token(RESUME_SEQ - 1),
                    on_metrics=lambda m: emit({"resume_run2_step": m.as_dict()}))
    torch.cuda.synchronize()
    launches2 = {k: flash.LAUNCHES[flash.kernel_name(k, 128)]
                 for k in flash.KERNELS}
    losses1 = [m.loss for m in h1]
    losses2 = [m.loss for m in h2]
    p1, p2 = first.model.state_dict(), second.model.state_dict()
    params_equal = p1.keys() == p2.keys() and all(
        torch.equal(p1[k], p2[k]) for k in p1)
    unequal = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    sums_equal = restored_sums == saved_sums
    check = {"check": "resume_bit_equal", "losses_run1": losses1,
             "losses_run2": losses2,
             "losses_equal": losses1[RESUME_EVERY:] == losses2,
             "params_equal": params_equal, "unequal_params": unequal[:8],
             "checksums_equal": sums_equal,
             "n_tensors": len(saved_sums),
             "launches_run1": launches, "launches_run2": launches2}
    emit(check)
    step_ms = 1e3 * statistics.median(m.step_time_s for m in h1[1:])
    ckpt_bytes = saves[0]["bytes"]
    emit({"checkpoint_summary": {
        "model": "llama3_600m_bench", "bytes_per_checkpoint": ckpt_bytes,
        "saves": saves,
        "save_ms_on_step_path": [1e3 * s["enqueue_s"] for s in saves],
        # Of which: the wait for the previous write, pinning (the first
        # save's), and the rest, enqueueing the copies and checksums.
        "wait_ms": [1e3 * s["wait_s"] for s in saves],
        "pin_ms": [1e3 * s["pin_s"] for s in saves],
        "enqueue_ms": [1e3 * (s["enqueue_s"] - s["wait_s"] - s["pin_s"])
                       for s in saves],
        "background_write_s": [s["write_s"] for s in saves],
        "write_gb_per_s": [s["bytes"] / s["write_s"] / 1e9 for s in saves],
        "restore_s": restore_s, "restore_gb_per_s": ckpt_bytes / restore_s / 1e9,
        "step_ms_median": step_ms,
        "step_ms_after_save": 1e3 * h1[RESUME_EVERY].step_time_s,
        "device": kind, "nvidia_smi": smi}})
    if not (check["losses_equal"] and params_equal and sums_equal
            and len(h1) == RESUME_STEPS):
        raise AssertionError("7b: the resumed run is not bit-equal")
    if not all(n > 0 for n in launches.values()) or not all(
            n > 0 for n in launches2.values()):
        raise AssertionError(f"7b: a head-dim-128 kernel was not launched: "
                             f"{launches} {launches2}")
    del first, second, p1, p2
    shutil.rmtree(ckpt_dir)
    return launches, step_ms


def _child(env: dict):
    """``python -m tpufw_torch.workloads.train_llama`` in the checkout
    with ``env`` on top of this process's environment."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpufw_torch.workloads.train_llama"],
        cwd=ROOT, env={**os.environ, **env}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, bufsize=1)


def sigterm_phase(prefix: str, workdir: str, kind, smi) -> None:
    """7c: the train_llama entry point on the 7a corpus gets SIGTERM after
    its second step line: it must print {"preempted": true, "step": N},
    exit 0 and leave step N on disk; a second child with
    TPUFW_TOTAL_STEPS=N+2 must resume at N and train 2 finite steps."""
    import signal

    ckpt_dir = os.path.join(workdir, "sigterm_ckpt")
    env = {"TPUFW_MODEL": "llama3_600m_bench", "TPUFW_DATA_PREFIX": prefix,
           "TPUFW_CHECKPOINT_DIR": ckpt_dir,
           "TPUFW_TOTAL_STEPS": str(SIGTERM_TOTAL_STEPS),
           "TPUFW_BATCH_SIZE": str(RESUME_BATCH),
           "TPUFW_SEQ_LEN": str(RESUME_SEQ)}
    proc = _child(env)
    lines, steps, t_sig = [], 0, None
    try:
        for ln in proc.stdout:
            lines.append(ln.rstrip())
            if ln.startswith('{"step"'):
                steps += 1
                if steps == 2 and t_sig is None:
                    proc.send_signal(signal.SIGTERM)
                    t_sig = time.perf_counter()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    exit_s = time.perf_counter() - t_sig if t_sig else None
    pre = [json.loads(ln) for ln in lines if ln.startswith('{"preempted"')]
    from tpufw_torch.train.checkpoint import CheckpointManager

    on_disk = CheckpointManager(ckpt_dir).all_steps()
    n = pre[0]["step"] if pre else None
    emit({"check": "sigterm_child", "rc": rc, "preempted": pre,
          "steps_on_disk": on_disk, "tail": lines[-4:]})
    if rc != 0 or not pre or on_disk != [n] or not 2 <= n < SIGTERM_TOTAL_STEPS:
        raise AssertionError(f"7c: the preempted child: rc {rc}, {pre}, "
                             f"{on_disk}; output {lines[-20:]}")
    proc = _child({**env, "TPUFW_TOTAL_STEPS": str(n + 2)})
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines2 = out.splitlines()
    resumed = any(ln == f"resumed from checkpoint at step {n}" for ln in lines2)
    steps2 = [json.loads(ln) for ln in lines2 if ln.startswith('{"step"')]
    cold = [json.loads(ln) for ln in lines2 if ln.startswith('{"cold_start')]
    emit({"preemption_summary": {
        "preempted_at_step": n, "signal_to_exit_s": exit_s,
        "resumed": resumed, "resumed_steps": [s["step"] for s in steps2],
        "resumed_losses": [s["loss"] for s in steps2],
        "resumed_cold_start_to_first_step_s":
            cold[0]["cold_start_to_first_step_s"] if cold else None,
        "device": kind, "nvidia_smi": smi}})
    if proc.returncode != 0 or not resumed or [s["step"] for s in steps2] \
            != [n + 1, n + 2] or not all(math.isfinite(s["loss"])
                                         for s in steps2):
        raise AssertionError(f"7c: the resumed child: rc {proc.returncode}; "
                             f"output {lines2[-20:]}")
    shutil.rmtree(ckpt_dir)


def hf_phase(torch, workdir: str, kind, smi, family="llama3_8b") -> None:
    """7d (``family`` "llama3_8b"): Llama-3-8B's serve slice (full width,
    LLAMA_HF_LAYERS layers, bf16 weights drawn as phase 5 draws them), or 9d
    ("mixtral_8x7b"): Mixtral-8x7B at full width and MIXTRAL_HF_LAYERS
    layers, bf16, dropless; exported with export_hf as sharded
    safetensors and served back through TPUFW_HF_CHECKPOINT and
    serve.build_generator: the serve slice's prompts' greedy tokens and
    prefill logits bit-equal to the in-memory model's; under
    TPUFW_QUANTIZE=int8, every int8 code and scale equal to quantizing the
    in-memory model. 10e ("deepseek_v2_lite"): DeepSeek-V2-Lite at full
    width and V2LITE_HF_LAYERS layers, bf16, dropless, likewise. Needs
    HF_DISK_GB (MIXTRAL_HF_DISK_GB, V2LITE_HF_DISK_GB) free on the
    checkout's disk."""
    from tpufw_torch import configs
    from tpufw_torch.infer import SamplingConfig, pad_prompts
    from tpufw_torch.models import model_for_config
    from tpufw_torch.tools.import_hf import export_hf
    from tpufw_torch.workloads import serve

    phase, need_gb, cfg, prompts, max_new = {
        "llama3_8b": lambda: ("7d", HF_DISK_GB,
                              *configs.llama3_8b_serve_slice()),
        "mixtral_8x7b": lambda: ("9d", MIXTRAL_HF_DISK_GB,
                                 *configs.mixtral_8x7b_serve_slice(
                                     n_layers=MIXTRAL_HF_LAYERS)),
        "deepseek_v2_lite": lambda: ("10e", V2LITE_HF_DISK_GB,
                                     *configs.deepseek_v2_lite_serve_slice(
                                         n_layers=V2LITE_HF_LAYERS)),
    }[family]()
    if family == "llama3_8b":
        cfg = dataclasses.replace(cfg, n_layers=LLAMA_HF_LAYERS)
    prefix = FAMILIES[family][1]
    free_gb = shutil.disk_usage(workdir).free / 1e9
    if free_gb < need_gb:
        raise AssertionError(
            f"{phase} needs {need_gb} GB free under {workdir}, has "
            f"{free_gb:.1f}")
    model = model_for_config(cfg, device="cuda", seed=0)
    hf_dir = os.path.join(workdir, "hf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = export_hf(model.state_dict(), cfg, hf_dir)
    write_s = time.perf_counter() - t0
    with _Env(hf_checkpoint=hf_dir, device="cuda",
              max_seq_len=cfg.max_seq_len), _RssPeak() as rss:
        t0 = time.perf_counter()
        loaded, lcfg, restored = serve.build_generator()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    tokens, pads = pad_prompts(prompts)
    tok = torch.tensor(tokens, device="cuda").long()
    pad = torch.tensor(pads, device="cuda").long()
    col = torch.arange(tok.shape[1], device="cuda")[None, :]
    seg = (col >= pad[:, None]).to(torch.int32)
    pos = torch.clamp(col - pad[:, None], min=0)
    with torch.no_grad():
        logits_equal = torch.equal(model(tok, pos, seg), loaded(tok, pos, seg))
    want = serve.generate_batch(model, prompts, max_new, SamplingConfig(), None)
    got = serve.generate_batch(loaded, prompts, max_new, SamplingConfig(), None)
    sd_equal = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), loaded.state_dict().values()))
    del loaded
    torch.cuda.empty_cache()
    qwant = serve.quantize_model(model).state_dict()
    del model
    torch.cuda.empty_cache()
    with _Env(hf_checkpoint=hf_dir, device="cuda", quantize="int8",
              max_seq_len=cfg.max_seq_len):
        qmodel, qcfg, _ = serve.build_generator()
    qgot = qmodel.state_dict()
    int8_equal = qgot.keys() == qwant.keys() and all(
        torch.equal(qgot[k], qwant[k]) for k in qwant)
    del qmodel, qgot, qwant
    torch.cuda.empty_cache()
    fp32_copy_gb = cfg.n_params() * 4 / 1e9
    # Anonymous memory where reported: mapped file pages are not a copy.
    held = "RssAnon" if "RssAnon" in rss.peak else "VmRSS"
    held_gb = rss.peak[held] - rss.start[held]
    check = {"check": prefix + "hf_round_trip", "restored": restored,
             "config_equal": lcfg.decode_config() == cfg,
             "state_dict_equal": sd_equal,
             "prefill_logits_equal": logits_equal,
             "greedy_tokens_equal": got == want,
             "int8_codes_and_scales_equal": int8_equal}
    emit(check)
    emit({prefix + "hf_import_summary": {
        "model": family, "n_layers": cfg.n_layers,
        "files": info["files"], "bytes": info["bytes"],
        "write_s": write_s, "write_gb_per_s": info["bytes"] / write_s / 1e9,
        "load_to_device_s": load_s,
        "load_gb_per_s": info["bytes"] / load_s / 1e9,
        "peak_rss_gb_during_load": rss.peak, "rss_gb_at_start": rss.start,
        "host_growth_gb": held_gb, "host_growth_of": held,
        "fp32_copy_gb": fp32_copy_gb, "disk_free_gb": free_gb,
        "device": kind, "nvidia_smi": smi}})
    if not all(v for k, v in check.items() if k != "check"):
        raise AssertionError(
            f"{phase}: the HF round trip is not bit-equal: {check}")
    if held_gb >= fp32_copy_gb:
        raise AssertionError(f"{phase}: the load held {held_gb:.1f} GB of "
                             "host memory, an fp32 copy's worth")
    shutil.rmtree(hf_dir)


def weights_phase(torch, kind, smi) -> dict:
    """Phase 7: 7a-7d in a gitignored directory of the checkout, each
    directory deleted once its check has passed. Returns 7b's launch
    counts."""
    # Earlier phases leave TPUFW_* serving knobs set; the loads and the
    # children of this phase see only their own.
    for k in [k for k in os.environ if k.startswith("TPUFW_")]:
        del os.environ[k]
    workdir = os.path.join(ROOT, "build-torch", f"phase7-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        prefix, stats = make_corpus(workdir)
        stats["pack_s"] = time.perf_counter() - t0
        emit({"corpus": stats})
        data = corpus_phase(torch, prefix)
        torch.cuda.empty_cache()
        PHASE_SECONDS["7a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches, step_ms = resume_phase(torch, prefix, workdir, kind, smi)
        torch.cuda.empty_cache()
        data["step_ms_600m"] = step_ms
        data["host_share_of_step"] = data["native_host_ms_per_batch"] / step_ms
        emit({"data_summary": data | {"device": kind, "nvidia_smi": smi}})
        PHASE_SECONDS["7b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sigterm_phase(prefix, workdir, kind, smi)
        PHASE_SECONDS["7c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hf_phase(torch, workdir, kind, smi)
        PHASE_SECONDS["7d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


# ----------------------------------------------------------- phase 8


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _router_post(port: int, body: dict):
    """(status, parsed reply) of ``POST /generate`` on the router."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        out = e.code, json.loads(e.read())
    return out + (time.perf_counter() - t0,)


def _never_migrated(torch, model, prompts, max_new, kv_quant,
                    page=DISAGG_PAGE):
    """Greedy tokens of ``prompts`` decoded together in one paged pool of
    the decode engine's shape (DISAGG_SLOTS rows of the model's length,
    pages of ``page``), each prompt prefilled by ``prefill_row`` into it:
    the run a migration must reproduce bit for bit."""
    from tpufw_torch.infer import PagedSlotPool, SamplingConfig, prefill_row

    greedy = SamplingConfig()
    pool = PagedSlotPool.create_paged(
        model, DISAGG_SLOTS, cache_len=model.cfg.max_seq_len,
        page=page, kv_quant=kv_quant, sampling=greedy,
        prefix_cache=False)
    outs = []
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            ids, _ = pool.acquire_pages(p, len(p) + max_new - 1)
            row, _f, first, _d, seen = prefill_row(
                model, p, None, sampling=greedy, eos_id=None, pad_to=len(p),
                cache_len=pool.cache_len)
            pool.insert_paged(slot, row, first, len(p), max_new - 1, ids, 0,
                              row_seen=seen)
            outs.append([first])
        steps = pool.decode_steps(max_new - 1).tolist()
    return [o + steps[i] for i, o in enumerate(outs)]


def migrate_phase(torch, model, prompts, max_new, kind, smi, sessions,
                  page=DISAGG_PAGE, prefix=""):
    """8a (and 10d: DeepSeek-V2-Lite's latent pages, ``prefix``
    "v2lite_"): the direct prompts through PrefillEngine ->
    LoopbackTransport -> DecodeEngine (a decoy page in the decode arena,
    pages of ``page``), bf16 then int8 KV, on the one model: tokens
    bit-equal to the never-migrated run. Returns the bf16 decode engine
    (8b reuses it; its spill tier writes drained sessions to
    ``sessions``) and the bf16 tokens."""
    from tpufw_torch.infer import SamplingConfig, generate_text
    from tpufw_torch.infer.spill import SpillTier
    from tpufw_torch.ops import flash
    from tpufw_torch.serve import bundle
    from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine
    from tpufw_torch.serve.transport import LoopbackTransport

    greedy = SamplingConfig()
    want = generate_text(model, prompts, max_new_tokens=max_new,
                         sampling=greedy)
    kept = None
    for kv in ("", "int8"):
        ref = _never_migrated(torch, model, prompts, max_new, kv, page)
        pe = PrefillEngine(model, sampling=greedy, page=page,
                           kv_quant=kv, n_slots=2)
        de = DecodeEngine(model, sampling=greedy, page=page,
                          kv_quant=kv, n_slots=DISAGG_SLOTS, chunk=16,
                          spill=SpillTier(0, sessions or ""))
        decoy = de.pool.allocator.alloc(1)
        lt = LoopbackTransport()
        torch.cuda.synchronize()
        flash.reset_launch_counts()
        slots, timing = [], []
        for p in prompts:
            t0 = time.perf_counter()
            data = pe.prefill(p, max_new)
            t1 = time.perf_counter()
            lt.a.send(data)
            got = lt.b.recv(timeout=60)
            t2 = time.perf_counter()
            slots.append(de.submit(got))
            t3 = time.perf_counter()
            decode_s = host_ms(torch, lambda: bundle.decode_bundle(got), 1)
            st = bundle.peek_trace(data)["stages"]
            timing.append({"prompt_tokens": len(p),
                           "pages": bundle.decode_bundle(data)["n_pages"],
                           "bytes": len(data), "stages": st,
                           "prefill_s": t1 - t0, "wire_s": t2 - t1,
                           "submit_s": t3 - t2,
                           "decode_bundle_ms": decode_s})
        outs = [de.collect(s) for s in slots]
        torch.cuda.synchronize()
        launches = dict(flash.LAUNCHES)
        name = "bf16" if not kv else "int8"

        def match(a, b):
            return sum(x == y for o, r in zip(a, b) for x, y in zip(o, r)
                       ) / (len(prompts) * max_new)

        # generate_text decodes a B=4 left-padded batch through a
        # contiguous cache: other shapes, so bf16 near-ties may flip. The
        # never-migrated pool run shows how much of that is the pool's.
        check = {
            "check": f"{prefix}migrate_{name}",
            "equal_never_migrated": outs == ref,
            "greedy_match_vs_generate_text": match(outs, want),
            "never_migrated_match_vs_generate_text": match(ref, want),
            "migrations": [pe.migrations, de.migrations],
            "decode_pages_in_use_after": de.pool.allocator.in_use,
            "flash_launches": launches,
        }
        emit(check)
        bad = []
        if outs != ref:
            bad.append("tokens differ from the never-migrated run")
        if any(len(o) != max_new for o in outs):
            bad.append("short output")
        if de.pool.allocator.in_use != len(decoy):
            bad.append("decode pages leaked")
        if any(launches.values()):
            bad.append("flash launched")
        if bad:
            raise AssertionError(f"{prefix}migrate ({name}): {bad}")
        long = max(timing, key=lambda t: t["prompt_tokens"])
        st, pages = long["stages"], long["pages"]
        encode_s = long["prefill_s"] - sum(st.values())
        splice_ms = long["submit_s"] * 1e3 - long["decode_bundle_ms"]
        emit({prefix + "migrate_summary": {
            "kv": name, "page": page, "prompt_tokens": long["prompt_tokens"],
            "pages": pages, "bundle_bytes": long["bytes"],
            "bundle_bytes_per_page": long["bytes"] / pages,
            "export_ms_per_page": st["export"] * 1e3 / pages,
            "encode_ms": encode_s * 1e3,
            "wire_ms": long["wire_s"] * 1e3,
            "decode_ms": long["decode_bundle_ms"],
            "splice_ms_per_page": splice_ms / pages,
            "ttft_prefill_compute_ms": (st["queue"] + st["admit"]
                                        + st["compute"]) * 1e3,
            "ttft_migration_ms": (st["export"] + encode_s + long["wire_s"]
                                  + long["submit_s"]) * 1e3,
            "per_prompt": [{k: t[k] for k in ("prompt_tokens", "pages",
                                              "bytes")}
                           | {"export_ms": t["stages"]["export"] * 1e3,
                              "submit_ms": t["submit_s"] * 1e3}
                           for t in timing],
            "device": kind, "nvidia_smi": smi}})
        if not kv:
            kept = (de, outs)
        del pe
    return kept


def disagg_phase(torch, model, de, direct, direct_out, max_new, kind, smi,
                 sessions):
    """8b: serve_prefill/serve_decode on loopback TCP behind a RouterServer
    over TcpReplicas; phase 6's 16 requests, its 4 requests sharing the
    448-token prefix and the direct prompts, concurrently; then a session
    drained off the decode engine mid-decode and resumed on a second one
    through the spill directory. Then 8d (``fleet_loop_phase``) on the
    weights and the decode engine left in rotation."""
    import threading

    import socket

    import numpy as np

    from tpufw_torch.infer import SamplingConfig
    from tpufw_torch.infer.spill import SpillTier
    from tpufw_torch.ops import flash
    from tpufw_torch.serve.bundle import load_session
    from tpufw_torch.serve.roles import (DecodeEngine, PrefillEngine,
                                         serve_decode, serve_prefill)
    from tpufw_torch.serve.router import RouterServer, TcpReplica

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(0)
    by_len = {n: [rng.integers(1, vocab, n).tolist() for _ in range(4)]
              for n in ONLINE_PROMPT_LENS}
    online = [by_len[n][i] for i in range(4)
              for n in reversed(ONLINE_PROMPT_LENS)]
    shared = rng.integers(1, vocab, ONLINE_PREFIX).tolist()
    prefixed = [shared + rng.integers(1, vocab, n).tolist()
                for n in (16, 24, 40, 56)]
    # A fresh prefill engine: 8a's trie holds the direct prompts' pages,
    # and a suffix prefill over them is not 8a's cold prefill in bf16.
    pe = PrefillEngine(model, sampling=SamplingConfig(), page=DISAGG_PAGE,
                       n_slots=2)
    de2 = DecodeEngine(model, sampling=SamplingConfig(), page=DISAGG_PAGE,
                       n_slots=DISAGG_SLOTS, chunk=16,
                       spill=SpillTier(0, sessions))
    socks, router = [], None
    try:
        psrv, pport = serve_prefill(pe, 0)
        dsrv, dport = serve_decode(de, 0)
        d2srv, d2port = serve_decode(de2, 0)
        socks += [psrv, dsrv, d2srv]
        router = RouterServer(
            [TcpReplica("prefill-0", "127.0.0.1", pport, "prefill")],
            [TcpReplica("decode-0", "127.0.0.1", dport, "decode")],
            port=0, page=DISAGG_PAGE, max_inflight=DISAGG_SLOTS,
            spill_dir=sessions)
        rport = router.port
        flash.reset_launch_counts()
        traffic = ([(p, ONLINE_NEW) for p in online + prefixed]
                   + [(p, max_new) for p in direct])
        t0 = time.perf_counter()
        runs = _concurrently([
            (lambda p=p, n=n: _router_post(rport, {"prompt": p,
                                                   "max_new": n}))
            for p, n in traffic])
        wall = time.perf_counter() - t0
        bad = []
        for (p, n), (code, body, _lat) in zip(traffic, runs):
            toks = body.get("tokens") or []
            if code != 200 or len(toks) != n or not all(
                    0 <= t < vocab for t in toks):
                bad.append(f"bad reply {code} {body.get('error')}")
        got_direct = [r[1].get("tokens") for r in runs[-len(direct):]]
        with _get(f"http://127.0.0.1:{rport}/healthz") as r:
            health = json.loads(r.read())
        metrics = _metrics(f"http://127.0.0.1:{rport}")
        launches = dict(flash.LAUNCHES)
        check = {
            "check": "disagg_router",
            "requests": [metrics["tpufw_router_requests_total"],
                         len(traffic)],
            "tokens": [metrics["tpufw_router_tokens_total"],
                       sum(n for _, n in traffic)],
            "rejects": metrics["tpufw_router_rejects_total"],
            "proxy_errors": metrics["tpufw_router_proxy_errors_total"],
            "healthz_ok": health["ok"], "inflight": health["inflight"],
            # The engine's own count: the router's snapshot is the one
            # the last reply carried, taken while others still decoded.
            "decode_slots_active": de.signals()["slots_active"],
            "direct_equal_8a": got_direct == direct_out,
            "prefix_hits": pe.pool.prefix_hits,
            "flash_launches": launches,
        }
        emit(check)
        if check["requests"][0] != check["requests"][1] or \
                check["tokens"][0] != check["tokens"][1]:
            bad.append("router counts differ from the traffic")
        if check["rejects"] or check["proxy_errors"] or not health["ok"] \
                or health["inflight"] or check["decode_slots_active"]:
            bad.append("health or errors")
        if got_direct != direct_out:
            bad.append("direct prompts' tokens differ from 8a")
        if any(launches.values()):
            bad.append("flash launched")
        if bad:
            raise AssertionError(f"8b: {bad[:4]}")
        ttft = [r[1]["ttft_s"] * 1e3 for r in runs]
        stage_keys = ("queue_wait", "admit", "prefill_queue",
                      "prefill_compute", "page_export", "wire", "splice",
                      "first_decode")
        stages = {k: {"p50_ms": _percentile([r[1]["stages"][k] * 1e3
                                             for r in runs], 0.5),
                      "mean_ms": statistics.fmean([r[1]["stages"][k] * 1e3
                                                   for r in runs])}
                  for k in stage_keys}
        summary = {
            "requests": len(traffic), "wall_s": wall,
            "output_tokens": sum(n for _, n in traffic),
            "tokens_per_s": sum(n for _, n in traffic) / wall,
            "router_ttft_ms_p50": _percentile(ttft, 0.5),
            "router_ttft_ms_p95": _percentile(ttft, 0.95),
            "latency_ms_p50": _percentile([r[2] * 1e3 for r in runs], 0.5),
            "stages": stages, "max_inflight": DISAGG_SLOTS,
            "decode_slots": DISAGG_SLOTS, "page": DISAGG_PAGE,
        }

        # The drain: the undisturbed run first, then the same request as
        # a session, drained off decode-0 once it has decoded a chunk.
        drain_p = direct[-1]
        code, body, _ = _router_post(rport, {"prompt": drain_p,
                                             "max_new": DISAGG_DRAIN_NEW})
        if code != 200:
            raise AssertionError(f"8b: undisturbed run {code} {body}")
        want = body["tokens"]
        router.add_replica(
            TcpReplica("decode-1", "127.0.0.1", d2port, "decode"), "decode")
        engines = {"decode-0": de, "decode-1": de2}
        drained = {}

        def drainer():
            # Drain whichever engine the router chose, after its first
            # decode chunk.
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline:
                for name, eng in engines.items():
                    try:
                        live = any(len(j["tokens"]) > 1
                                   for j in list(eng._jobs.values()))
                    except RuntimeError:  # the dict changed under us
                        live = False
                    if live:
                        drained.update(eng.drain(), replica=name)
                        return
                time.sleep(0.002)

        th = threading.Thread(target=drainer)
        th.start()
        code, body, lat = _router_post(rport, {
            "prompt": drain_p, "max_new": DISAGG_DRAIN_NEW,
            "session": "drain-8b"})
        th.join(timeout=120)
        src = engines.get(drained.get("replica"))
        dst = next((e for n, e in engines.items()
                    if n == body.get("replica")), None)
        check = {"check": "disagg_drain", "code": code,
                 "drained": drained, "resumed": body.get("resumed"),
                 "replica": body.get("replica"),
                 "tokens_equal_undisturbed": body.get("tokens") == want,
                 "sessions_drained": src.sessions_drained if src else 0,
                 "sessions_resumed": dst.sessions_resumed if dst else 0,
                 "session_file_left": load_session(sessions, "drain-8b")
                 is not None,
                 "live_slots_after": [e.signals()["slots_active"]
                                      for e in engines.values()]}
        emit(check)
        if code != 200 or not body.get("resumed") or body.get("tokens") \
                != want or drained.get("sessions") != ["drain-8b"] or \
                dst is src or check["sessions_resumed"] != 1 or \
                check["session_file_left"] or any(
                    check["live_slots_after"]):
            raise AssertionError(f"8b drain: {check}")
        summary["drain_request_ms"] = lat * 1e3
        summary.update({"device": kind, "nvidia_smi": smi})
        emit({"disagg_summary": summary})
        # 8d on the same gang, through the decode engine the drain left
        # in rotation.
        keep = next(n for n in engines if n != drained["replica"])
        ports = {"decode-0": dport, "decode-1": d2port}
        _timed("8d", lambda: fleet_loop_phase(
            torch, model, ports[keep], engines[keep], direct, direct_out,
            max_new, kind, smi, os.path.dirname(sessions)))
    finally:
        if router is not None:
            router.close()
        for s in socks:
            # A close alone leaves the accept thread blocked, holding the
            # engines and the weights (found by phase 9's memory).
            s.shutdown(socket.SHUT_RDWR)
            s.close()


def _fleet_events(path, kinds):
    from tpufw_torch.obs.events import read_events

    return [e for e in read_events(path) if e.get("kind") in kinds]


def fleet_loop_phase(torch, model, dport, dengine, direct, direct_out,
                     max_new, kind, smi, workdir) -> None:
    """8d: the closed autoscaling loop on 8b's gang (its weights and its
    undrained decode engine, beside a fresh prefill engine as 8b's is,
    behind a RouterServer of their own): a
    FleetCollector over the router and both replicas, an SloTracker of
    FLEET_WINDOWS, a ScalingRecommender on the disaggregated manifest
    subscribed by a GangExecutor whose decode factory serves a new
    DecodeEngine on the same weights. Burst -> burn-rate alert -> one
    decision (decode +1) -> a third replica that serves (the direct prompts
    give 8a's tokens) -> recovery -> idle -> the executor removes its own
    replica; then a capacity sweep of the same gang."""
    import socket
    import threading

    from tpufw_torch.infer import SamplingConfig
    from tpufw_torch.load import (GangExecutor, MixConfig, ReplayClient,
                                  SweepConfig, TraceWriter, read_trace,
                                  run_sweep, schedule, schedule_digest)
    from tpufw_torch.obs import events as obs_events
    from tpufw_torch.obs import fleet
    from tpufw_torch.obs.registry import Registry
    from tpufw_torch.obs.slo import SloTracker
    from tpufw_torch.ops import flash
    from tpufw_torch.serve.roles import (DecodeEngine, PrefillEngine,
                                         serve_decode, serve_prefill)
    from tpufw_torch.serve.router import RouterServer, TcpReplica

    class Spawned(TcpReplica):
        """A decode replica the executor spawned, over its own framed-TCP
        server, which ``close`` shuts (the executor closes what it
        removes)."""

        def __init__(self, name, engine, sock, port):
            super().__init__(name, "127.0.0.1", port, "decode")
            self.engine, self._sock = engine, sock

        def close(self):
            self._sock.shutdown(socket.SHUT_RDWR)
            self._sock.close()

    fdir = os.path.join(workdir, "fleet8d")
    os.makedirs(fdir, exist_ok=True)
    ev_path = os.path.join(fdir, fleet.EVENTS_FILENAME)
    manifest = os.path.join(ROOT, "deploy", "manifests",
                            "13-serve-disagg-v5e8-jobset.yaml")
    flash.reset_launch_counts()
    # A fresh prefill engine, as 8b's: a trie holding the direct prompts'
    # pages would prefill their suffixes only, which is not 8a's bf16.
    pe = PrefillEngine(model, sampling=SamplingConfig(), page=DISAGG_PAGE,
                       n_slots=2)
    psock, pport = serve_prefill(pe, 0)
    events = obs_events.EventLog(ev_path)
    reg = Registry()
    slo = SloTracker(reg, events, ttft_ms=60000.0, tok_ms=60000.0,
                     goal=0.99, windows=FLEET_WINDOWS,
                     tenants={"burst": (60000.0, 0.0001)})
    prefill = TcpReplica("prefill-0", "127.0.0.1", pport, "prefill")
    decode = TcpReplica("decode-base", "127.0.0.1", dport, "decode")
    router = RouterServer([prefill], [decode], port=0, page=DISAGG_PAGE,
                          max_inflight=DISAGG_SLOTS, events=events,
                          registry=reg, slo=slo)
    base = f"http://127.0.0.1:{router.port}"
    fast, slow = (f"{int(w)}s" for w in FLEET_WINDOWS)
    store = fleet.SeriesStore(os.path.join(fdir, fleet.SERIES_FILENAME))
    collector = executor = None
    traces = []
    try:
        recommender = fleet.ScalingRecommender(
            fdir, manifest, cooldown_s=FLEET_COOLDOWN_S, events=events)
        rules = (
            fleet.BurnRateRule(name="load_tok_burn", metric="tok",
                               fast_window=fast, slow_window=slow,
                               severity="page", scale="decode:+1"),
            fleet.AlertRule(name="load_idle_traffic",
                            series="tpufw_fleet_requests_per_s", op="<",
                            threshold=0.05, for_s=FLEET_IDLE_HOLD_S,
                            severity="info", scale="decode:-1"),
        )
        collector = fleet.FleetCollector(
            [fleet.Target("router", "router", router.render_metrics),
             fleet.Target("prefill-0", "prefill", prefill.signals),
             fleet.Target("decode-base", "decode", decode.signals)],
            store, events=events, rules=rules, recommender=recommender,
            health_fn=router.health)
        spawned = {}

        def spawn_decode(name):
            # Built the way 8b builds its decode engines; a failure raises
            # into the executor, which records an "error" action (held
            # below).
            eng = DecodeEngine(model, sampling=SamplingConfig(),
                               page=DISAGG_PAGE, n_slots=DISAGG_SLOTS,
                               chunk=16)
            sock, port = serve_decode(eng, 0)
            spawned[name] = Spawned(name, eng, sock, port)
            return spawned[name]

        executor = GangExecutor(router, spawn={"decode": spawn_decode},
                                events=events, slo=slo, burn_window=fast)
        executor.subscribe(recommender)

        def decode_names():
            with _get(base + "/healthz") as r:
                reps = json.loads(r.read())["replicas"]
            return sorted(n for n, d in reps.items() if d["role"] == "decode")

        bad = []
        derived0 = collector.scrape_once()
        pre = {"prefill": derived0.get('tpufw_fleet_replicas{role="prefill"}'),
               "decode": derived0.get('tpufw_fleet_replicas{role="decode"}'),
               "router": derived0.get('tpufw_fleet_replicas{role="router"}'),
               "unhealthy": derived0.get("tpufw_fleet_replicas_unhealthy"),
               "alerts": len(_fleet_events(ev_path, ("fleet_alert",)))}
        if pre != {"prefill": 1.0, "decode": 1.0, "router": 1.0,
                   "unhealthy": 0.0, "alerts": 0}:
            bad.append(f"pre-traffic sweep {pre}")

        # The burst, open loop through the router's HTTP port, with the
        # collector sweeping beside it until the decision lands.
        events.emit("load_phase", phase="burst")
        slo.set_phase("burst")
        mix = MixConfig(**FLEET_BURST)
        reqs = schedule(mix)
        trace = TraceWriter(os.path.join(fdir, "load-trace.jsonl"))
        traces.append(trace)
        client = ReplayClient(base, trace, threads=DISAGG_SLOTS, rung=0,
                              offered_rps=mix.rate_rps)
        burst = {}
        th = threading.Thread(target=lambda: burst.update(client.run(reqs)))
        th.start()
        while not executor.actions:
            collector.scrape_once()
            if not th.is_alive() and not executor.actions:
                collector.scrape_once()
                break
            time.sleep(FLEET_SCRAPE_S)
        th.join(timeout=600)
        slo.tenants["burst"] = (60000.0, 60000.0)  # the targets relaxed
        adds = [a for a in executor.actions if a["action"] == "add"]
        name = adds[0]["replica"] if adds else ""
        decisions = sorted(f for f in os.listdir(fdir)
                           if f.startswith("fleet-rec-")
                           and f.endswith(".json"))
        artifact = {}
        if decisions:
            with open(os.path.join(fdir, decisions[0])) as f:
                artifact = json.load(f)
        alerts = _fleet_events(ev_path, ("fleet_alert",))
        for e in alerts:
            obs_events.validate(e)
        up = {"burst": burst, "schedule_digest": schedule_digest(reqs),
              "decisions": decisions, "pools": artifact.get("pools"),
              "actions": [(a["action"], a["replica"])
                          for a in executor.actions],
              "decode_replicas": decode_names(),
              "alerts_firing": [e["rule"] for e in alerts
                                if e["state"] == "firing"]}
        if burst.get("completed") != len(reqs) or decisions != [
                "fleet-rec-0001.json"] or artifact.get("pools") != {
                "decode": {"from": 1, "to": 2}} or up["actions"] != [
                ("add", name)] or up["decode_replicas"] != [
                name, "decode-base"] or "load_tok_burn" not in \
                up["alerts_firing"]:
            bad.append(f"scale-out {up}")
        if bad:
            raise AssertionError(f"8d: {bad}")

        # Recovery: the burst tenant's violations age out of the fast
        # window, then good traffic: the direct prompts, together. With
        # the gang quiet the router re-reads every replica's signals, so
        # both decode replicas rank as idle and the tie goes by name:
        # the spawned replica ("decode-auto1") before the base one
        # ("decode-base"), so these requests go to the new replica.
        time.sleep(FLEET_WINDOWS[0] + 0.2)
        engines = {"decode-base": dengine, name: spawned[name].engine}
        before = {n: e.signals()["migrations"] for n, e in engines.items()}
        router._refresh_all()
        served = {}

        def post(prompt, n):
            t_send = time.time()
            code, body, _lat = _router_post(
                router.port, {"prompt": prompt, "max_new": n,
                              "tenant": "burst"})
            if code != 200:
                raise AssertionError(f"8d: reply {code} {body}")
            served.setdefault(body["replica"], []).append(
                t_send + body["ttft_s"])
            return body

        bodies = _concurrently([(lambda p=p: post(p, max_new))
                                for p in direct])
        recovered = executor.poll_recovery()
        for r in read_trace(trace.path):
            if r.get("replica") == name and "ttft_s" in r:
                served.setdefault(name, []).append(
                    r["ts_sent"] + r["ttft_s"])
        got = [b["tokens"] for b in bodies]
        serve_check = {
            "check": "fleet_loop_spawned_serves", "replica": name,
            "direct_equal_8a": got == direct_out,
            "direct_replicas": [b["replica"] for b in bodies],
            "migrations": {n: e.signals()["migrations"] - before[n]
                           for n, e in engines.items()},
            "spawned_migrations_total": spawned[name].signals()[
                "migrations"],
            "spawned_requests": len(served.get(name, [])),
            "recovered": recovered,
        }
        emit(serve_check)
        if got != direct_out:
            bad.append("direct prompts' tokens differ from 8a")
        if serve_check["direct_replicas"] != [name] * len(direct) or \
                serve_check["migrations"][name] != len(direct):
            bad.append("the spawned replica did not serve")
        if not recovered or recovered["replica"] != name or \
                recovered.get("burn", 1.0) >= 1.0:
            bad.append(f"no recovery {recovered}")

        # Scale-in: no traffic; the idle rule fires after its hold and the
        # recommender (cooldown elapsed) steps decode -1.
        events.emit("load_phase", phase="idle")
        slo.set_phase("")
        deadline = time.perf_counter() + 30
        while len(decode_names()) > 1 and time.perf_counter() < deadline:
            collector.scrape_once()
            time.sleep(FLEET_SCRAPE_S)
        removes = [a for a in executor.actions if a["action"] == "remove"]
        errors = [a for a in executor.actions if a["action"] == "error"]
        chain = [(e["kind"], e.get("action") or e.get("state")
                  or e.get("phase"))
                 for e in _fleet_events(ev_path, (
                     "fleet_alert", "fleet_recommendation", "scale_action",
                     "load_phase"))]
        want = [("load_phase", "burst"), ("fleet_alert", "firing"),
                ("fleet_recommendation", None), ("scale_action", "add"),
                ("scale_action", "recovered"), ("load_phase", "idle"),
                ("scale_action", "remove")]
        it = iter(chain)
        ordered = all(any(k == wk and (wa is None or a == wa) for k, a in it)
                      for wk, wa in want)
        decisions = sorted(f for f in os.listdir(fdir)
                           if f.startswith("fleet-rec-")
                           and f.endswith(".yaml"))
        with open(os.path.join(fdir, decisions[0])) as f:
            patched = fleet.read_manifest_replicas(f.read())
        n_trace = len(read_trace(trace.path))
        down = {"check": "fleet_loop", "decode_replicas": decode_names(),
                "removes": [a["replica"] for a in removes],
                "errors": errors, "decisions": decisions,
                "artifact_replicas": patched, "causal_order": ordered,
                "chain": chain, "trace_records": [n_trace, len(reqs)],
                "flash_launches": dict(flash.LAUNCHES)}
        emit(down)
        if down["decode_replicas"] != ["decode-base"] or down["removes"] != [
                name] or errors or len(decisions) != 2 or patched != {
                "prefill": 1, "decode": 2} or not ordered or \
                n_trace != len(reqs):
            bad.append("scale-in or causal chain")
        if any(flash.LAUNCHES.values()):
            bad.append("flash launched")
        if bad:
            raise AssertionError(f"8d: {bad}; {serve_check}")

        viol = _fleet_events(ev_path, ("slo_violation",))
        fired = [e for e in alerts if e["state"] == "firing"]
        rec_ev = _fleet_events(ev_path, ("fleet_recommendation",))
        t_decision = artifact["ts"]
        loop = {
            "violation_to_alert_s": fired[0]["ts"] - viol[0]["ts"],
            "alert_to_decision_s": rec_ev[0]["ts"] - fired[0]["ts"],
            "decision_to_spawned_first_token_s":
                min(served[name]) - t_decision,
            "recovery_s": recovered["recovery_s"],
            "burst": {"requests": len(reqs), "process": mix.process,
                      "offered_rps": mix.rate_rps,
                      "duration_s": mix.duration_s,
                      "schedule_digest": schedule_digest(reqs),
                      "wall_s": burst["wall_s"]},
            "scrapes": collector.scrapes,
            "collector_busy_cpu_s_per_scrape":
                collector.busy_cpu_s / collector.scrapes,
            "collector_busy_s_per_scrape":
                collector.busy_s / collector.scrapes,
            "artifact": {"file": decisions[0], "replicas": patched,
                         "reason": artifact["reason"]},
            "windows_s": list(FLEET_WINDOWS), "scrape_s": FLEET_SCRAPE_S,
            "device": kind, "nvidia_smi": smi,
        }
        emit({"fleet_loop_summary": loop})

        # The capacity sweep on the same gang: the default mix, the
        # default targets, with the recommender detached.
        collector.recommender = None
        strace = TraceWriter(os.path.join(fdir, "sweep-trace.jsonl"))
        traces.append(strace)
        sweep = SweepConfig(rungs=SWEEP_RUNGS, hold_s=SWEEP_HOLD_S,
                            settle_s=SWEEP_SETTLE_S, threads=DISAGG_SLOTS)
        payload = run_sweep(base, MixConfig(seed=0), sweep, trace=strace,
                            events=events, slo=slo)
        rungs = []
        for r in payload["rungs"]:
            t = r["tenants"].get("default", {})
            sm = r["summary"]
            rungs.append({
                "offered_rps": r["offered_rps"], "offered": sm["offered"],
                "achieved_rps": sm["completed"] / sm["wall_s"],
                "completed": sm["completed"], "rejected": sm["rejected"],
                "errors": sm["errors"], "attainment": r["attainment"],
                "ttft_p50_s": t.get("ttft_p50_s"),
                "ttft_p95_s": t.get("ttft_p95_s"),
                "tok_p50_s": t.get("tok_p50_s"),
                "goodput_tok_s": r["goodput_tok_s"],
                "stages_mean_s": r["stages_mean_s"],
                "schedule_digest": r["schedule_digest"]})
        knee = payload["knee"]
        top = payload["rungs"][-1]
        emit({"load_sweep_summary": {
            "rungs": rungs, "knee": knee,
            "knee_at": ("none" if knee is None else
                        "top rung: capacity lies beyond it"
                        if knee["rung"] == top["rung"] else
                        f"rung {knee['rung']}"),
            "goal": sweep.goal, "ttft_target_s": sweep.ttft_target_s,
            "tok_target_s": sweep.tok_target_s, "hold_s": sweep.hold_s,
            "settle_s": sweep.settle_s, "decode_replicas": 1,
            "decode_slots": DISAGG_SLOTS, "device": kind,
            "nvidia_smi": smi}})
        if any(r["errors"] for r in rungs):
            raise AssertionError(f"8d sweep: errors {rungs}")
        if any(flash.LAUNCHES.values()):
            raise AssertionError(f"8d sweep: flash launched "
                                 f"{dict(flash.LAUNCHES)}")
    finally:
        for t in traces:
            t.close()
        if executor is not None:
            executor.close()
        if collector is not None:
            collector.stop()
        else:
            store.close()
        events.close()
        router.close()
        psock.shutdown(socket.SHUT_RDWR)
        psock.close()


def _read_lines(proc, out: list):
    """Collect ``proc``'s stdout lines into ``out`` from a thread."""
    import threading

    def run():
        for ln in proc.stdout:
            out.append(ln.rstrip())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _banner(proc, lines, deadline):
    """The child's ``serving_role`` line, waiting until ``deadline``."""
    while time.perf_counter() < deadline:
        for ln in list(lines):
            if ln.startswith('{"serving_role"'):
                return json.loads(ln)
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    raise AssertionError(f"8c: no banner (rc {proc.poll()}): {lines[-20:]}")


def fleet_children(rport, fleet_dir, env, workdir, banner) -> dict:
    """8c's fleet and load checks on the running router child: its banner
    says ``"fleet": true``, its series file holds records of the router
    and both replicas, ``python -m tpufw_torch.obs.fleet query`` returns
    them, and ``python -m tpufw_torch.load replay`` of a LOAD_CHILD_S
    poisson mix through the router exits 0 with every request served and
    leaves a trace ``read_trace`` reads, one record a request."""
    from tpufw_torch.load import read_trace
    from tpufw_torch.obs import fleet

    t0 = time.perf_counter()
    want = {"router", "prefill-0", "decode-0"}
    series = os.path.join(fleet_dir, fleet.SERIES_FILENAME)
    seen = set()
    deadline = time.perf_counter() + 10 * FLEET_SCRAPE_S + 5
    while time.perf_counter() < deadline:
        seen = {r["replica"] for r in fleet.read_series(series)
                if not r.get("stale")}
        if want <= seen:
            break
        time.sleep(FLEET_SCRAPE_S / 2)
    q = subprocess.run(
        [sys.executable, "-m", "tpufw_torch.obs.fleet", "query", "--dir",
         fleet_dir, "--json"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=60)
    queried = json.loads(q.stdout) if q.returncode == 0 else {}
    load_dir = os.path.join(workdir, "c_load")
    os.makedirs(load_dir, exist_ok=True)
    lenv = dict(env, TPUFW_LOAD_SEED="0", TPUFW_LOAD_PROCESS="poisson",
                TPUFW_LOAD_RATE_RPS="2", TPUFW_LOAD_DURATION_S=str(
                    LOAD_CHILD_S), TPUFW_LOAD_DIR=load_dir,
                TPUFW_LOAD_THREADS=str(DISAGG_SLOTS))
    lp = subprocess.run(
        [sys.executable, "-m", "tpufw_torch.load", "replay", "--base-url",
         f"http://127.0.0.1:{rport}"], cwd=ROOT, env=lenv,
        capture_output=True, text=True, timeout=300)
    lines = [ln for ln in lp.stdout.splitlines() if ln.startswith("{")]
    replay = json.loads(lines[-1])["load_replay"] if lines else {}
    trace = read_trace(os.path.join(load_dir, "load-trace.jsonl"))
    out = {"banner_fleet": banner.get("fleet"),
           "series_replicas": sorted(seen),
           "query_replicas": sorted(queried.get("replicas", {})),
           "query_rc": q.returncode, "load_rc": lp.returncode,
           "replay": replay, "trace_records": len(trace),
           "trace_ok": sum(1 for r in trace if r["status"] == 200),
           "seconds": time.perf_counter() - t0}
    if banner.get("fleet") is not True or not want <= seen or \
            not want <= set(out["query_replicas"]) or lp.returncode or \
            not replay.get("offered") or \
            out["trace_records"] != replay["offered"] or \
            out["trace_ok"] != replay["offered"]:
        raise AssertionError(f"8c fleet/load: {out}; {q.stderr[-500:]} "
                             f"{lp.stderr[-500:]}")
    return out


def entry_phase(torch, direct, direct_out, max_new, kind, smi, workdir):
    """8c: ``python -m tpufw_torch.workloads.serve`` as three children,
    TPUFW_SERVE_ROLE prefill, decode and router, on the serve slice's
    weights from TPUFW_SEED=0; the direct prompts through the router's
    HTTP port give 8a's bf16 tokens; the router's fleet collector
    (TPUFW_FLEET_SCRAPE_S) has recorded the router and both replicas, and
    ``python -m tpufw_torch.obs.fleet query`` reads them back; a fourth
    child, ``python -m tpufw_torch.load replay``, sends a TPUFW_LOAD_* mix
    through the router and leaves a trace ``read_trace`` reads; SIGTERM
    drains the decode child, which exits 0."""
    import signal

    free = torch.cuda.mem_get_info()[0] / 1e9
    if free < DISAGG_FREE_GB:
        raise AssertionError(f"8c: {free:.1f} GB free, needs "
                             f"{DISAGG_FREE_GB}")
    pport, dport, rport = _free_port(), _free_port(), _free_port()
    fleet_dir = os.path.join(workdir, "c_fleet")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("TPUFW_")}
    base.update({"TPUFW_MODEL": "llama3_8b_serve_slice", "TPUFW_SEED": "0",
                 "TPUFW_SERVE_PAGE": str(DISAGG_PAGE),
                 "TPUFW_SERVE_SLOTS": str(DISAGG_SLOTS),
                 "TPUFW_SERVE_CHUNK": "16",
                 "TPUFW_SERVE_DRAIN_GRACE_S": "0.5"})
    roles = {
        "prefill": {"TPUFW_SERVE_PEER_PORT": str(pport)},
        "decode": {"TPUFW_SERVE_PEER_PORT": str(dport),
                   "TPUFW_KV_SPILL_DIR": os.path.join(workdir, "c_sessions")},
        "router": {"TPUFW_ROUTER_PORT": str(rport),
                   "TPUFW_ROUTER_PREFILL": f"127.0.0.1:{pport}",
                   "TPUFW_ROUTER_DECODE": f"127.0.0.1:{dport}",
                   "TPUFW_FLEET_SCRAPE_S": str(FLEET_SCRAPE_S),
                   "TPUFW_FLEET_DIR": fleet_dir},
    }
    procs, lines, startup = {}, {}, {}

    def start(role):
        procs[role] = subprocess.Popen(
            [sys.executable, "-m", "tpufw_torch.workloads.serve"],
            cwd=ROOT, env={**base, **roles[role], "TPUFW_SERVE_ROLE": role},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            bufsize=1)
        lines[role] = []
        _read_lines(procs[role], lines[role])
        return time.perf_counter()

    def ready(role, t0):
        banner = _banner(procs[role], lines[role], time.perf_counter() + 300)
        startup[role] = dict(banner, startup_s=time.perf_counter() - t0)

    try:
        # The engines listen before the router probes them.
        t0 = {r: start(r) for r in ("prefill", "decode")}
        for r in ("prefill", "decode"):
            ready(r, t0[r])
        ready("router", start("router"))
        outs = []
        for p in direct:
            code, body, _ = _router_post(rport, {"prompt": p,
                                                 "max_new": max_new})
            if code != 200:
                raise AssertionError(f"8c: router reply {code} {body}")
            outs.append(body["tokens"])
        fleet_check = fleet_children(rport, fleet_dir, base, workdir,
                                     startup["router"])
        t_sig = time.perf_counter()
        procs["decode"].send_signal(signal.SIGTERM)
        rc = procs["decode"].wait(timeout=120)
        check = {"check": "disagg_entry_points",
                 "direct_equal_8a": outs == direct_out, "decode_rc": rc,
                 "decode_exit_s": time.perf_counter() - t_sig,
                 "startup_s": {r: s["startup_s"] for r, s in startup.items()},
                 "devices": {r: s.get("device") for r, s in startup.items()},
                 "fleet": fleet_check, "device": kind, "nvidia_smi": smi}
        emit(check)
        if outs != direct_out or rc != 0:
            raise AssertionError(f"8c: {check}; decode output "
                                 f"{lines['decode'][-10:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def disaggregated_phase(torch, kind, smi) -> None:
    """Phase 8: 8a (migration on one set of Llama-3-8B weights), 8b (the
    wire, the router and a drain), 8c (the three entry points as
    children), in a gitignored directory of the checkout that is deleted
    after."""
    from tpufw_torch.configs import llama3_8b_serve_slice
    from tpufw_torch.models import model_for_config

    cfg, direct, max_new = llama3_8b_serve_slice()
    emit({"disagg": "llama3_8b", "n_layers": cfg.n_layers,
          "params": cfg.n_params(), "param_dtype": "bfloat16",
          "max_seq_len": cfg.max_seq_len, "page": DISAGG_PAGE,
          "decode_slots": DISAGG_SLOTS, "prompt_lens": [len(p)
                                                        for p in direct],
          "max_new_tokens": max_new, "sampling": "greedy"})
    workdir = os.path.join(ROOT, "build-torch", f"phase8-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    try:
        sessions = os.path.join(workdir, "sessions")
        model = model_for_config(cfg, device="cuda", seed=0)
        de, direct_out = migrate_phase(torch, model, direct, max_new, kind,
                                       smi, sessions)
        disagg_phase(torch, model, de, direct, direct_out, max_new, kind,
                     smi, sessions)
        del model, de
        gc.collect()
        torch.cuda.empty_cache()
        entry_phase(torch, direct, direct_out, max_new, kind, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ----------------------------------------------------------- phase 9


def moe_online(torch, model, kind, smi, family, modes,
               spec_check=False) -> None:
    """9c (``family`` "mixtral_8x7b", mode "paged_bf16") and 10c
    ("deepseek_v2_lite", modes "contiguous", "paged_bf16" and
    "paged_int8"): the bf16 MoE serve model behind ``_Server`` (slot
    scheduler, ONLINE_SLOTS slots, greedy; paged modes at pages of
    ONLINE_PAGE): phase 6's 16 concurrent SSE requests, then the 4 sharing
    the ONLINE_PREFIX-token prefix, ONLINE_NEW tokens each. Every reply
    full-length and in vocabulary, /metrics counting the requests and
    tokens sent, /healthz ok, no slot occupied after the drain, no flash
    launch; paged: a prefix hit, and only the trie's pages in use after
    the drain. Then one admission sequence straight through a contiguous
    and a paged pool gives step logits within SERVE_LOGITS_TOL (the paged
    step with the contiguous step's routing, MOE_CHECKS; a paged int8 mode
    against the paged bf16 pool within INT8_TOL), and with ``spec_check``
    ``spec_pool_check``'s verify block vs k+1 single steps. Prints a
    ``<prefix>online_summary`` per mode; raises AssertionError on a failed
    check."""
    import numpy as np

    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    cfg = model.cfg
    prefix = FAMILIES[family][1]
    k = cfg.experts_per_token
    rng = np.random.default_rng(0)
    by_len = {n: [rng.integers(1, cfg.vocab_size, n).tolist()
                  for _ in range(4)] for n in ONLINE_PROMPT_LENS}
    prompts = [by_len[n][i] for i in range(4)
               for n in reversed(ONLINE_PROMPT_LENS)]
    shared = rng.integers(1, cfg.vocab_size, ONLINE_PREFIX).tolist()
    prefixed = [shared + rng.integers(1, cfg.vocab_size, n).tolist()
                for n in (16, 24, 40, 56)]
    direct = [by_len[n][0] for n in ONLINE_PROMPT_LENS]
    page = {"TPUFW_SERVE_PAGE": str(ONLINE_PAGE)}
    envs = {"contiguous": {}, "paged_bf16": page,
            "paged_int8": dict(page, TPUFW_SERVE_KV_QUANT="int8")}
    rows = torch.zeros(ONLINE_SLOTS, 1, dtype=torch.bool, device="cuda")
    rows[: len(direct)] = True
    r_ref = []
    ref_logits, ref_tokens = pool_run(torch, model, direct, "contiguous", 32,
                                      router=r_ref)
    paged_bf16 = None
    for mode in modes:
        paged = mode != "contiguous"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launch_counts()
        srv, base = _start_server(serve, envs[mode], model=model)
        sched = srv._batcher
        warm_s, warm_steps = sched.decode_s, sched.decode_steps_run
        try:
            t0 = time.perf_counter()
            runs = []
            for wave in (prompts, prefixed):
                runs += _concurrently([
                    (lambda p=p: _stream(base, {"prompts": [p],
                                                "max_new_tokens": ONLINE_NEW}))
                    for p in wave])
            wall = time.perf_counter() - t0
            n_req = len(prompts) + len(prefixed)
            bad = [toks for toks, _, _ in runs if len(toks) != ONLINE_NEW
                   or not all(0 <= t < cfg.vocab_size for t in toks)]
            with _get(base + "/healthz") as r:
                healthy = json.loads(r.read())["ok"] is True
            metrics = _metrics(base)
            launches = dict(flash.LAUNCHES)
            steps = sched.decode_steps_run - warm_steps
            check = {
                "check": prefix + "online" + (f"_{mode}" if len(modes) > 1
                                              else ""),
                "bad_outputs": len(bad), "healthz_ok": healthy,
                "requests": [metrics["tpufw_serve_requests_total"], n_req],
                "tokens": [metrics["tpufw_serve_tokens_generated_total"],
                           n_req * ONLINE_NEW],
                "errors": metrics["tpufw_serve_request_errors_total"],
                "slots_occupied_after": metrics["tpufw_serve_slots_occupied"],
                "prefix_hits": metrics.get("tpufw_serve_prefix_hits_total",
                                           0.0),
                "pages_in_use_after": sched.pages_in_use,
                "trie_pages": len(sched.pool.prefix) if paged else 0,
                "flash_launches": launches,
            }
            ttft = [r[1] * 1e3 for r in runs]
            summary = {
                "model": family, "n_layers": cfg.n_layers,
                "capacity_factor": cfg.capacity_factor, "mode": mode,
                "slots": ONLINE_SLOTS, "page": ONLINE_PAGE if paged else 0,
                "wall_s": wall, "requests": n_req,
                "output_tokens": ONLINE_NEW * n_req,
                "tokens_per_s": ONLINE_NEW * n_req / wall,
                "ttft_ms_p50": _percentile(ttft, 0.5),
                "ttft_ms_p95": _percentile(ttft, 0.95),
                "latency_ms_p50": _percentile([r[2] * 1e3 for r in runs],
                                              0.5),
                "decode_ms_per_step": ((sched.decode_s - warm_s) / steps * 1e3
                                       if steps else None),
                "decode_steps": steps,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_pages_in_use": sched.peak_pages_in_use,
                "pages_total": sched.pages_total,
                "device": kind, "nvidia_smi": smi,
            }
        finally:
            srv.shutdown()
            for key in [key for key in os.environ
                        if key.startswith("TPUFW_")]:
                del os.environ[key]
        if paged:
            # MOE_CHECKS: the held paged step takes the reference step's
            # routing (int8 KV: the paged bf16 pool's).
            kv = "paged_int8" if mode == "paged_int8" else "paged"
            r_free = []
            free_logits, tokens = pool_run(torch, model, direct, kv, 32,
                                           router=r_free)
            if mode == "paged_int8" and paged_bf16 is not None:
                want, want_tokens, r_want, tol, vs = (*paged_bf16, INT8_TOL,
                                                      "paged_bf16")
            else:
                want, want_tokens, r_want, tol, vs = (
                    ref_logits, ref_tokens, r_ref, SERVE_LOGITS_TOL,
                    "contiguous")
            logits, _ = pool_run(torch, model, direct, kv, 1, replay=r_want)
            if mode == "paged_bf16":
                paged_bf16 = (logits, tokens, r_want)
            check["step_logits_free_routing"] = moe_free_routing(
                torch, free_logits, want, r_free, r_want, k, rows)
            check["step_logits_paged_vs_" + vs] = rel_err(torch, logits, want)
            check["tol"] = tol
            check["greedy_match_vs_" + vs] = sum(
                x == y for o, r in zip(tokens, want_tokens)
                for x, y in zip(o, r)) / (len(tokens) * 32)
        if mode == "paged_bf16" and spec_check:
            spec = spec_pool_check(torch, model, direct)
            check["verify_block_vs_single_steps"] = spec
        emit(check)
        emit({prefix + "online_summary": summary})
        failed = [key for key in ("requests", "tokens")
                  if check[key][0] != check[key][1]]
        if (check["bad_outputs"] or not healthy or check["errors"]
                or check["slots_occupied_after"] or any(launches.values())):
            failed.append("outputs, health, slots or flash")
        if paged and (check["prefix_hits"] <= 0
                      or check["pages_in_use_after"] != check["trie_pages"]):
            failed.append("prefix or pages")
        if paged and (check["step_logits_paged_vs_" + vs][1] > tol
                      or check["step_logits_free_routing"]
                      ["topk_differ_share"] > MOE_FLIP_TOL):
            failed.append("step logits")
        if any(v["logits"][1] > SERVE_LOGITS_TOL
               for v in check.get("verify_block_vs_single_steps",
                                  {}).values()):
            failed.append("verify block logits")
        if failed:
            raise AssertionError(f"{prefix}online {mode}: {failed}: {check}")


def moe_train_pair(torch, family, n_layers, gen, kind, smi) -> dict:
    """9a (``family`` "mixtral_8x7b") and 10a ("deepseek_v2_lite"): the
    family's train slice at ``n_layers`` for STEPS steps through
    ``Trainer.run`` under the einsum dispatch (with the flash vs plain
    logits check), then, freed, under the sorted one from the same seed
    on the same batches: finite losses, every flash kernel of the head dim
    launched in both, the step-1 losses and gradient norms within
    MIXTRAL_LOSS_TOL and MIXTRAL_GNORM_TOL. Returns {kernel: {mode:
    launches}}; raises AssertionError on a failed check."""
    prefix = FAMILIES[family][1]
    runs = {}
    for mode in ("einsum", "sorted"):
        norms = []
        launches, losses = train_phase(
            torch, family, n_layers, gen, kind, smi,
            logits_check=mode == "einsum", moe_dispatch=mode,
            grad_norms=norms)
        runs[mode] = (launches, losses, norms)
        gc.collect()
        torch.cuda.empty_cache()
    (_, le, ge), (_, ls, gs) = runs["einsum"], runs["sorted"]
    gap = {"loss_step1": abs(le[0] - ls[0]) / abs(le[0]),
           "grad_norm_step1": abs(ge[0] - gs[0]) / abs(ge[0])}
    emit({"check": prefix + "dispatch_modes_step1", "einsum_loss": le[0],
          "sorted_loss": ls[0], "einsum_grad_norm": ge[0],
          "sorted_grad_norm": gs[0], "relative_gap": gap,
          "tol": {"loss_step1": MIXTRAL_LOSS_TOL,
                  "grad_norm_step1": MIXTRAL_GNORM_TOL}})
    if (gap["loss_step1"] > MIXTRAL_LOSS_TOL
            or gap["grad_norm_step1"] > MIXTRAL_GNORM_TOL):
        raise AssertionError(f"{family}: the dispatch modes disagree at "
                             f"step 1: {gap}")
    return {k: {mode: runs[mode][0][k] for mode in runs}
            for k in runs["einsum"][0]}


def mixtral_phase(torch, chip, kind, smi, gen) -> dict:
    """Phase 9: Mixtral-8x7B widths. 9a: the train slice at
    MIXTRAL_TRAIN_LAYERS layers under both dispatch modes
    (``moe_train_pair``). 9b: the serve slice at MIXTRAL_SERVE_LAYERS
    layers (``serve_phase``),
    bf16 then int8, with 9c (``moe_online``, paged bf16) on the bf16 model
    between. 9d: the HF round trip at width (``hf_phase``) in a gitignored
    directory of the checkout, deleted after. Returns {kernel: {mode:
    launches}} of 9a; raises AssertionError on a failed check."""
    # What earlier phases left on the card: every peak below includes it.
    emit({"phase9_allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9})
    launches = moe_train_pair(torch, "mixtral_8x7b", MIXTRAL_TRAIN_LAYERS, gen,
                              kind, smi)
    serve_phase(torch, chip, kind, smi, family="mixtral_8x7b",
                after_bf16=lambda m: moe_online(torch, m, kind, smi,
                                                "mixtral_8x7b",
                                                ("paged_bf16",)),
                n_layers=MIXTRAL_SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    workdir = os.path.join(ROOT, "build-torch", f"phase9-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    try:
        hf_phase(torch, workdir, kind, smi, family="mixtral_8x7b")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


# ---------------------------------------------------------- phase 10


def _timed(name, fn):
    """Run ``fn`` and record its wall seconds under ``name`` in
    PHASE_SECONDS; returns what ``fn`` returns."""
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


def v2lite_phase(torch, chip, kind, smi, gen) -> dict:
    """Phase 10: DeepSeek-V2-Lite. 10a: the train slice at
    V2LITE_TRAIN_LAYERS layers under both dispatch modes
    (``moe_train_pair``: every head-dim-192 kernel launched in both). 10b:
    the serve slice at V2LITE_SERVE_LAYERS layers (``serve_phase``), bf16
    then int8, with 10c
    (``moe_online``: contiguous, paged and paged int8 latent KV) and 10d
    (``migrate_phase`` at pages of V2LITE_PAGE, bf16 and int8 latent
    pages) on the bf16 model between. 10e: the HF round trip of
    V2LITE_HF_LAYERS layers (``hf_phase``) in a gitignored directory of the
    checkout, deleted after. Returns {kernel: {mode: launches}} of 10a;
    raises AssertionError on a failed check."""
    emit({"phase10_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9})
    family = "deepseek_v2_lite"
    launches = _timed("10a", lambda: moe_train_pair(
        torch, family, V2LITE_TRAIN_LAYERS, gen, kind, smi))

    def after_bf16(model):
        from tpufw_torch import configs

        _timed("10c", lambda: moe_online(
            torch, model, kind, smi, family,
            ("contiguous", "paged_bf16", "paged_int8"), spec_check=True))
        _, prompts, max_new = configs.deepseek_v2_lite_serve_slice()
        _timed("10d", lambda: migrate_phase(
            torch, model, prompts, max_new, kind, smi, None,
            page=V2LITE_PAGE, prefix="v2lite_"))

    t0 = time.perf_counter()
    serve_phase(torch, chip, kind, smi, family=family, after_bf16=after_bf16,
                n_layers=V2LITE_SERVE_LAYERS)
    PHASE_SECONDS["10b"] = (time.perf_counter() - t0 - PHASE_SECONDS["10c"]
                            - PHASE_SECONDS["10d"])
    gc.collect()
    torch.cuda.empty_cache()
    workdir = os.path.join(ROOT, "build-torch", f"phase10-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    try:
        _timed("10e", lambda: hf_phase(torch, workdir, kind, smi,
                                       family=family))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


# ---------------------------------------------------------- phase 11


def _adapters_and_base(torch, model):
    """(clones of every adapter, checksums of every base tensor); a
    sharded model's whole tensors, gathered one at a time."""
    from tpufw_torch.models.lora import is_lora_name
    from tpufw_torch.train.checkpoint import checksums
    from tpufw_torch.train.sharding import full_tensor

    sd = model.state_dict()
    adapters = {k: full_tensor(v.detach()).clone() for k, v in sd.items()
                if is_lora_name(k)}
    base = checksums({k: v for k, v in sd.items() if not is_lora_name(k)})
    return adapters, base


def _only_adapters_moved(torch, model, before) -> dict:
    """Check (b): every base tensor's checksums as before training, every
    adapter changed. Returns the counts; raises AssertionError."""
    adapters, base = _adapters_and_base(torch, model)
    moved = sum(not torch.equal(adapters[k], v) for k, v in before[0].items())
    changed = [k for k, v in base.items() if before[1][k] != v]
    out = {"adapters": len(adapters), "adapters_moved": moved,
           "base_tensors": len(base), "base_tensors_changed": len(changed)}
    if changed or moved != len(adapters) or not adapters:
        raise AssertionError(f"LoRA training moved the base or left an "
                             f"adapter: {out} {changed[:4]}")
    return out


def lora_llama(torch, kind, smi, gen) -> dict:
    """Phase 11a: ``llama3_8b_lora_train_slice`` (all 32 layers, rank 16)
    for LORA_STEPS steps through ``Trainer.run``, launch counters zeroed
    just before. Checks: (a) step 0's logits with B = 0 bit-equal to the
    rank-0 model's on the same base tensors; (b) after training every
    base tensor bit-unchanged (checksums) and every adapter moved; (c)
    ``merge_lora`` gives a rank-0 model whose logits, computed by fp32
    twins on the same tensors, lie within LORA_MERGE_TOL of each row's
    largest |logit| of the unmerged model's (the bf16 logits' gap and
    top-1 agreement printed beside the bf16 noise floor);
    (d) ``quantize_params`` raises on the unmerged state dict and succeeds
    on the merged one. Every loss finite and every head-dim-128 kernel
    launched. Returns the launch counts; raises AssertionError."""
    from tpufw_torch import configs
    from tpufw_torch.models import model_for_config
    from tpufw_torch.models.lora import is_lora_name, merge_lora
    from tpufw_torch.ops import flash
    from tpufw_torch.ops.quant import quantize_params
    from tpufw_torch.train import Trainer, synthetic_batches

    cfg, tcfg = configs.llama3_8b_lora_train_slice(total_steps=LORA_STEPS)
    trainer = Trainer(cfg, tcfg, device="cuda")
    model = trainer.init_state(seed=0)
    n_adapter = sum(p.numel() for p in model.parameters() if p.requires_grad)
    tokens = torch.randint(0, cfg.vocab_size, (1, LORA_TOKENS), generator=gen,
                           device="cuda")
    rank0_cfg = dataclasses.replace(cfg, lora_rank=0)

    def logits(c, state, fp32=False):
        """Logits of a model of config ``c`` built on ``meta`` and handed
        ``state``'s tensors (no copy); ``fp32``: its twin computing in
        fp32 with plain attention."""
        if fp32:
            c = dataclasses.replace(c, dtype=torch.float32,
                                    attention_backend="xla")
        m = model_for_config(c, device="meta")
        m.load_state_dict(state, assign=True)
        with torch.no_grad():
            return m(tokens)

    def row_gap(a, b):
        """The worst row's largest |a - b| over that row's largest |b|."""
        return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())

    # (a) B = 0: the LoRA model is its base, bit for bit.
    with torch.no_grad():
        step0 = model(tokens)
    base0 = logits(rank0_cfg, {k: v for k, v in model.state_dict().items()
                               if not is_lora_name(k)})
    check_a = {"check": "lora_step0_equals_base", "bit_equal":
               bool(torch.equal(step0, base0)),
               "max_abs_diff": float((step0 - base0).abs().max())}
    emit(check_a)
    del step0, base0
    if not check_a["bit_equal"]:
        raise AssertionError(f"LoRA step 0 differs from its base: {check_a}")
    before = _adapters_and_base(torch, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    emit({"train": "llama3_8b LoRA", "reduced": {},
          "params": cfg.n_params(), "adapter_params": n_adapter,
          "lora_rank": cfg.lora_rank, "lora_alpha": cfg.lora_alpha,
          "n_layers": cfg.n_layers, "batch_size": tcfg.batch_size,
          "seq_len": tcfg.seq_len, "loss_chunk_size": tcfg.loss_chunk_size,
          "remat_policy": cfg.remat_policy,
          "attention_backend": cfg.attention_backend})
    flash.reset_launch_counts()
    history = trainer.run(
        synthetic_batches(tcfg.batch_size, tcfg.seq_len, cfg.vocab_size,
                          seed=0),
        model_flops_per_token=cfg.flops_per_token(tcfg.seq_len - 1),
        on_metrics=lambda m: emit({"lora_step": m.as_dict()}),
    )
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    path = [flash.kernel_name(k, 128) for k in flash.KERNELS]
    summary = {
        "steps": len(history), "losses": [m.loss for m in history],
        **_steady(history),
        "mfu_flops": "Meter: flops_per_token = 6 x the base's matmul "
                     "parameters + attention scores, as tpufw counts it; "
                     "a LoRA step computes no base weight gradient",
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "model": "llama3_8b_lora",
        "n_layers": cfg.n_layers, "seq_len": tcfg.seq_len,
        "device": kind, "nvidia_smi": smi,
    }
    emit({"lora_train_summary": summary})
    if len(history) != LORA_STEPS or not all(
            math.isfinite(m.loss) for m in history):
        raise AssertionError(f"LoRA: losses {summary['losses']}")
    if not all(launches[k] > 0 for k in path):
        raise AssertionError(f"LoRA: a kernel was not launched: {launches}")
    # (b) Only the adapters moved.
    trainer.optimizer = None
    emit({"check": "lora_only_adapters_moved"}
         | _only_adapters_moved(torch, model, before))
    del before
    # (c) The merged rank-0 model against the unmerged one, held in fp32
    # twins on the same tensors: in bf16 each merged weight rounds anew
    # (W + dW, not W), a re-rounding of the whole model whose gap is the
    # bf16 noise floor, printed beside it.
    with torch.no_grad():
        tuned = model(tokens)
    state = model.state_dict()
    tuned32 = logits(cfg, state, fp32=True)
    try:
        quantize_params(state)
        raise AssertionError("quantize_params took an unmerged LoRA tree")
    except ValueError as e:
        refused = str(e)
    merged = merge_lora(state, alpha=cfg.lora_alpha)
    del state
    trainer.model = model = None
    gc.collect()
    torch.cuda.empty_cache()
    got32 = logits(rank0_cfg, merged, fp32=True)
    got = logits(rank0_cfg, merged)
    check_c = {"check": "lora_merged_vs_unmerged_logits",
               "tokens": LORA_TOKENS,
               "worst_row_gap_fp32": row_gap(got32, tuned32),
               "top1_agreement_fp32": float(
                   (got32.argmax(-1) == tuned32.argmax(-1)).float().mean()),
               "worst_row_gap_bf16": row_gap(got, tuned),
               "top1_agreement_bf16": float(
                   (got.argmax(-1) == tuned.argmax(-1)).float().mean()),
               "bf16_noise_floor_unmerged_vs_fp32": row_gap(tuned, tuned32),
               "tol_fp32": LORA_MERGE_TOL}
    emit(check_c)
    del got, tuned, got32, tuned32
    if not check_c["worst_row_gap_fp32"] <= LORA_MERGE_TOL:
        raise AssertionError(f"merged logits disagree: {check_c}")
    # (d) The merged tree quantizes.
    q = quantize_params(merged)
    n_int8 = sum(t.dtype == torch.int8 for t in q.values())
    emit({"check": "lora_quantize", "unmerged_refused": refused,
          "merged_int8_tensors": n_int8})
    del q, merged
    gc.collect()
    torch.cuda.empty_cache()
    if n_int8 != 7 * cfg.n_layers + 1:
        raise AssertionError(f"merged tree quantized {n_int8} tensors")
    return {k: launches[k] for k in path}, summary["losses"]


def lora_mixtral(torch, kind, smi) -> dict:
    """Phase 11b: Mixtral-8x7B widths at MIXTRAL_TRAIN_LAYERS layers with
    rank-16 adapters on the attention projections and the expert stacks,
    MIXTRAL_LORA_STEPS steps under each dispatch from the same seed on the
    same batches, counters zeroed before each: finite losses, every
    head-dim-128 kernel launched, check (b); the step-1 losses printed.
    Returns {kernel: {mode: launches}}; raises AssertionError."""
    from tpufw_torch import configs
    from tpufw_torch.ops import flash
    from tpufw_torch.train import Trainer, synthetic_batches

    cfg, tcfg = configs.mixtral_8x7b_train_slice(
        MIXTRAL_TRAIN_LAYERS, total_steps=MIXTRAL_LORA_STEPS)
    runs = {}
    for mode in ("einsum", "sorted"):
        mcfg = dataclasses.replace(cfg, lora_rank=16, lora_alpha=16.0,
                                   moe_dispatch=mode)
        trainer = Trainer(mcfg, tcfg, device="cuda")
        model = trainer.init_state(seed=0)
        before = _adapters_and_base(torch, model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launch_counts()
        history = trainer.run(
            synthetic_batches(tcfg.batch_size, tcfg.seq_len, mcfg.vocab_size,
                              seed=0),
            model_flops_per_token=mcfg.flops_per_token(tcfg.seq_len - 1))
        torch.cuda.synchronize()
        launches = dict(flash.LAUNCHES)
        trainer.optimizer = None
        moved = _only_adapters_moved(torch, model, before)
        summary = {"steps": len(history), "losses": [m.loss for m in history],
                   **_steady(history),
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": launches, "moe_dispatch": mode,
                   "n_layers": mcfg.n_layers, "lora_rank": mcfg.lora_rank,
                   "adapters": moved, "device": kind, "nvidia_smi": smi}
        emit({"mixtral_lora_train_summary": summary})
        runs[mode] = (launches, summary["losses"])
        del trainer, model, before
        gc.collect()
        torch.cuda.empty_cache()
        if not all(math.isfinite(x) for x in summary["losses"]):
            raise AssertionError(f"Mixtral LoRA {mode}: {summary['losses']}")
        if not all(launches[flash.kernel_name(k, 128)] > 0
                   for k in flash.KERNELS):
            raise AssertionError(f"Mixtral LoRA {mode}: a kernel was not "
                                 f"launched: {launches}")
    le, ls = runs["einsum"][1][0], runs["sorted"][1][0]
    emit({"check": "mixtral_lora_dispatch_step1", "einsum_loss": le,
          "sorted_loss": ls, "relative_gap": abs(le - ls) / abs(le)})
    return {flash.kernel_name(k, 128): {m: runs[m][0][flash.kernel_name(
        k, 128)] for m in runs} for k in flash.KERNELS}


def lora_phase(torch, kind, smi, gen) -> tuple[dict, dict, list]:
    """Phase 11: LoRA, 11a Llama-3-8B at all 32 layers (``lora_llama``),
    11b Mixtral under both dispatches (``lora_mixtral``). Returns their
    launch counts and 11a's losses (phase 14b's reference)."""
    emit({"phase11_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9})
    llama, losses = _timed("11a", lambda: lora_llama(torch, kind, smi, gen))
    mixtral = _timed("11b", lambda: lora_mixtral(torch, kind, smi))
    return llama, mixtral, losses


# ---------------------------------------------------------- phase 12


def vision_run(torch, name, mcfg, chip, kind, smi,
               steps=VISION_STEPS) -> dict:
    """One vision model through ``VisionTrainer.run`` at VISION_BATCH
    images of 224 px for ``steps`` of a VISION_STEPS-step schedule
    (images staged on the card; each rank its batch shard's rows, all of
    them outside a gang): finite losses; for a model with BatchNorm, the
    running statistics moved, and an eval-mode forward uses them (it
    leaves them as they are, and its logits move when they do) where a
    train-mode one uses the batch's; a ``vision_train_summary`` line
    (images/s, MFU against the card's bf16 peak, peak memory). Returns
    {"losses", "bn_stats" after step MESH_VISION_STEPS, "history",
    "peak_mem_gb"}. Raises AssertionError."""
    import itertools

    from tpufw_torch.train import (
        VisionTrainer,
        VisionTrainerConfig,
        synthetic_images,
    )
    from tpufw_torch.train.vision import batch_rows

    tcfg = VisionTrainerConfig(batch_size=VISION_BATCH, image_size=224,
                               num_classes=1000, total_steps=VISION_STEPS,
                               lr=0.1 if name == "resnet50" else 1e-3,
                               handle_preemption=False)
    trainer = VisionTrainer(mcfg, tcfg, device="cuda")
    model = trainer.init_state(seed=0)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    data = synthetic_images(VISION_BATCH, 224, 1000, device="cuda")
    at_step = {}

    def on_metrics(m):
        emit({"vision_step": name} | m.as_dict())
        if m.step == MESH_VISION_STEPS:
            at_step.update({k: v.clone() for k, v in
                            model.state_dict().items() if k in stats})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = trainer.run(
        batch_rows(itertools.islice(data, steps), *trainer.batch_shard()),
        flops_per_image=mcfg.flops_per_image(224), on_metrics=on_metrics)
    torch.cuda.synchronize()
    summary = {"model": name, "steps": len(history), "gang": trainer.gang,
               "losses": [m.loss for m in history], **_steady(history),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "batch_size": VISION_BATCH, "image_size": 224,
               "flops_per_image": mcfg.flops_per_image(224),
               "peak_bf16_flops": chip.peak_bf16_flops,
               "dtype": str(mcfg.dtype),
               "norm_dtype": str(getattr(mcfg, "norm_dtype", None)),
               "remat": getattr(mcfg, "remat", None),
               "device": kind, "nvidia_smi": smi}
    summary["images_per_sec_median"] = summary.pop(
        "tokens_per_sec_per_gpu_median")
    trainer.optimizer = None
    out = {"losses": summary["losses"], "bn_stats": at_step,
           "history": history, "peak_mem_gb": summary["peak_mem_gb"]}
    if len(history) != steps or not all(
            math.isfinite(x) for x in summary["losses"]):
        emit({"vision_train_summary": summary})
        raise AssertionError(f"{name}: losses {summary['losses']}")
    if stats:
        sd = model.state_dict()
        summary["bn_stats_moved"] = sum(
            not torch.equal(v, sd[k]) for k, v in stats.items())
        summary["bn_stats"] = len(stats)
        images = next(data)["images"][:VISION_EVAL_BATCH]
        model.eval()
        with torch.no_grad():
            run_stats = {k: sd[k].clone() for k in stats}
            ev = model(images)
            ev_again = model(images)
            untouched = all(torch.equal(sd[k], v) for k, v in run_stats.items())
            sd["bn_init.running_var"].mul_(4.0)
            ev_moved = model(images)
            sd["bn_init.running_var"].copy_(run_stats["bn_init.running_var"])
            model.train()
            tr = model(images)
            for k, v in run_stats.items():
                sd[k].copy_(v)
        summary["eval"] = {
            "finite": bool(torch.isfinite(ev).all()),
            "deterministic": bool(torch.equal(ev, ev_again)),
            "leaves_running_stats": untouched,
            "moves_with_running_var": float((ev_moved - ev).abs().max()),
            "differs_from_train_mode": float((tr - ev).abs().max())}
        emit({"vision_train_summary": summary})
        e = summary["eval"]
        if (summary["bn_stats_moved"] != len(stats) or not e["finite"]
                or not e["deterministic"] or not untouched
                or not e["moves_with_running_var"] > 0
                or not e["differs_from_train_mode"] > 0):
            raise AssertionError(f"{name}: BatchNorm statistics {summary}")
    else:
        emit({"vision_train_summary": summary})
    return out


VISION_MODELS = ("vit_b16", "resnet50")


def vision_config(torch, name):
    """ViT-B/16 (bf16, remat) or ResNet-50 (norm_dtype bf16, the
    workload's default)."""
    from tpufw_torch.models import VIT_CONFIGS, ResNetConfig

    if name == "vit_b16":
        return VIT_CONFIGS["vit_b16"]
    return ResNetConfig(norm_dtype=torch.bfloat16)


def vision_phase(torch, chip, kind, smi) -> dict:
    """Phase 12: ViT-B/16 and ResNet-50 through ``vision_run``. Returns
    each model's run (phase 17c's reference)."""
    emit({"phase12_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9})
    out = {}
    for sub, name in zip("ab", VISION_MODELS):
        out[name] = _timed("12" + sub, lambda n=name: vision_run(
            torch, n, vision_config(torch, n), chip, kind, smi))
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- phase 13


def _write_jsonl(path: str, rows) -> str:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def _words(rng, n: int, alphabet: str) -> str:
    """``n`` words of 2-9 letters drawn from ``alphabet`` by ``rng``."""
    return " ".join("".join(rng.choice(list(alphabet), rng.integers(2, 10)))
                    for _ in range(n))


def post_train_data(workdir: str, seed: int = 0) -> dict:
    """Phase 13's JSONL files, drawn from ``seed``: multi-turn
    conversations (SFT), preference pairs (DPO) and retrieval pairs
    (embeddings); returns their paths and the assistant turns' texts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lower, upper = "abcdefghijklmnopqrstuvwxyz", "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    convs, replies = [], []
    for _ in range(SFT_CONVERSATIONS):
        turns = [{"role": "system", "content": _words(rng, 12, lower)}]
        for _ in range(int(rng.integers(2, 5))):
            turns.append({"role": "user",
                          "content": _words(rng, int(rng.integers(20, 80)),
                                            lower)})
            reply = _words(rng, int(rng.integers(20, 120)), upper)
            turns.append({"role": "assistant", "content": reply})
            replies.append(reply)
        convs.append({"messages": turns})
    pairs = [{"prompt": _words(rng, int(rng.integers(40, 140)), lower),
              "chosen": _words(rng, int(rng.integers(10, 60)), upper),
              "rejected": _words(rng, int(rng.integers(10, 60)), upper)}
             for _ in range(4 * DPO_PAIRS)]
    retrieval = []
    for i in range(EMBED_PAIRS + 4):
        topic = _words(rng, 3, lower)
        retrieval.append({"query": f"what is {topic} {i}?",
                          "positive": f"{topic} {i} is " + _words(rng, 30,
                                                                 lower)})
    return {
        "sft": _write_jsonl(os.path.join(workdir, "chats.jsonl"), convs),
        "replies": replies,
        "dpo": _write_jsonl(os.path.join(workdir, "prefs.jsonl"), pairs),
        "embed": _write_jsonl(os.path.join(workdir, "pairs.jsonl"),
                              retrieval),
    }


def _recorded(trainer, keys=()) -> list:
    """Wrap ``trainer.train_step`` to keep each step's ``keys`` metrics
    (device tensors, read after the run); returns the list it fills."""
    out = []
    step_fn = trainer.train_step

    def train_step(batch):
        m = step_fn(batch)
        out.append({k: m[k] for k in keys})
        return m

    trainer.train_step = train_step
    return out


def _floats(rows) -> list:
    return [{k: float(v) for k, v in r.items()} for r in rows]


def _d128_launches(flash, launches) -> dict:
    path = [flash.kernel_name(k, 128) for k in flash.KERNELS]
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return {k: launches[k] for k in path}


def _sft_trained_runs(batch) -> list:
    """The byte strings of each maximal run of trained target positions
    of ``batch`` (``shift_and_mask``'s mask, on the host)."""
    import numpy as np

    tok, seg, m = batch["tokens"], batch["segment_ids"], batch["loss_mask"]
    mask = m[:, 1:] * (seg[:, :-1] == seg[:, 1:]) * (seg[:, 1:] > 0)
    runs = []
    for row, rmask in zip(tok[:, 1:], mask):
        cur = []
        for t, on in zip(row.tolist(), rmask.tolist()):
            if on:
                cur.append(t)
            elif cur:
                runs.append(bytes(x - 1 for x in cur))
                cur = []
        if cur:
            runs.append(bytes(x - 1 for x in cur))
    return runs if np.asarray(mask).sum() else []


def sft_run(torch, data, kind, smi) -> dict:
    """13a: SFT of ``llama3_8b_lora_train_slice`` (all 32 layers, rank 16)
    for SFT_STEPS steps on ``sft_batches`` of phase 13's conversations
    (``llama3`` template, the byte tokenizer through ``resolve_encode``),
    counters zeroed just before ``Trainer.run``. Checks: finite losses;
    each run of trained positions decodes to part of an assistant turn
    (its content and the ``<|eot_id|>`` footer), checked on the host from
    the batches; the base unchanged and every adapter moved; every d128
    kernel launched. Returns the launches."""
    from tpufw_torch import configs
    from tpufw_torch.ops import flash
    from tpufw_torch.train import Trainer, sft_batches
    from tpufw_torch.workloads._common import resolve_encode

    cfg, tcfg = configs.llama3_8b_lora_train_slice(total_steps=SFT_STEPS)
    trainer = Trainer(cfg, tcfg, device="cuda")
    model = trainer.init_state(seed=0)
    before = _adapters_and_base(torch, model)
    seen = []

    def batches():
        for b in sft_batches(data["sft"], tcfg.batch_size, tcfg.seq_len,
                             resolve_encode("bytes"), template="llama3"):
            seen.append(b)
            yield b

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    history = trainer.run(
        batches(),
        model_flops_per_token=cfg.flops_per_token(tcfg.seq_len - 1))
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    trainer.optimizer = None
    moved = _only_adapters_moved(torch, model, before)
    footer = b"<|eot_id|>"
    turns = [r.encode() + footer for r in data["replies"]]
    seen = seen[:len(history)]
    runs = [r for b in seen for r in _sft_trained_runs(b)]
    strays = [r for r in runs if not any(r in t for t in turns)]
    trained = sum(float(b["loss_mask"][:, 1:].sum()) for b in seen)
    summary = {"steps": len(history), "losses": [m.loss for m in history],
               **_steady(history),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "model": "llama3_8b_lora",
               "template": "llama3", "tokenizer": "bytes",
               "batch_size": tcfg.batch_size, "seq_len": tcfg.seq_len,
               "trained_target_share": trained / (
                   len(seen) * tcfg.batch_size * (tcfg.seq_len - 1)),
               "trained_runs": len(runs), "stray_runs": len(strays),
               "adapters": moved, "device": kind, "nvidia_smi": smi}
    emit({"sft_train_summary": summary})
    del trainer, model, before
    if len(history) != SFT_STEPS or not all(
            math.isfinite(m.loss) for m in history):
        raise AssertionError(f"SFT: losses {summary['losses']}")
    if strays or not runs:
        raise AssertionError(f"SFT: trained positions outside the assistant "
                             f"turns: {strays[:2]}")
    return _d128_launches(flash, launches)


def dpo_run(torch, data, kind, smi) -> dict:
    """13b: DPO of the same LoRA slice, DPO_PAIRS pairs (2 x DPO_PAIRS
    rows) of DPO_SEQ tokens, beta DPO_BETA, DPO_STEPS steps, the
    reference the bypassed base. Checks: step 0 at ln 2 within
    DPO_ANCHOR_TOL with accuracy 0.5 (the largest |margin| printed);
    finite later steps; the base unchanged, every adapter moved; every
    d128 kernel launched. MFU on the 4/3 count (the reference forward).
    Returns the launches."""
    from tpufw_torch import configs
    from tpufw_torch.ops import flash
    from tpufw_torch.train import DPOConfig, DPOTrainer, dpo_batches
    from tpufw_torch.train.sft import byte_encode

    cfg, tcfg = configs.llama3_8b_lora_train_slice(total_steps=DPO_STEPS)
    tcfg = dataclasses.replace(tcfg, batch_size=2 * DPO_PAIRS,
                               seq_len=DPO_SEQ)
    trainer = DPOTrainer(cfg, tcfg, device="cuda",
                         dpo=DPOConfig(beta=DPO_BETA))
    model = trainer.init_state(seed=0)
    before = _adapters_and_base(torch, model)
    rec = _recorded(trainer, ("loss", "accuracy", "margin",
                                     "reward_chosen", "reward_rejected"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    history = trainer.run(
        dpo_batches(data["dpo"], DPO_PAIRS, DPO_SEQ, byte_encode,
                    template="llama3"),
        model_flops_per_token=cfg.flops_per_token(DPO_SEQ - 1) * 4.0 / 3.0)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    metrics = _floats(rec)
    trainer.optimizer = None
    moved = _only_adapters_moved(torch, model, before)
    step0 = metrics[0]
    summary = {"steps": len(history), "metrics": metrics, **_steady(history),
               "mfu_flops": "4/3 x the Meter's 6N count of the base: the "
                            "reference forward adds 2N",
               "step0_loss_minus_ln2": step0["loss"] - math.log(2.0),
               "step0_abs_margin": abs(step0["margin"]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "beta": DPO_BETA,
               "rows": 2 * DPO_PAIRS, "seq_len": DPO_SEQ,
               "reference": "the policy's base, adapters bypassed",
               "adapters": moved, "device": kind, "nvidia_smi": smi}
    emit({"dpo_train_summary": summary})
    del trainer, model, before
    if len(history) != DPO_STEPS or not all(
            math.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"DPO: {metrics}")
    if abs(step0["loss"] - math.log(2.0)) > DPO_ANCHOR_TOL or \
            step0["accuracy"] != 0.5:
        raise AssertionError(f"DPO step 0 is not the ln 2 anchor: {step0}")
    return _d128_launches(flash, launches)


def grpo_run(torch, kind, smi, gen, n_steps=GRPO_STEPS,
             prompts=None) -> tuple[dict, dict]:
    """13c: GRPO of the same LoRA slice: GRPO_PROMPTS prompts x group
    GRPO_GROUP rows of GRPO_SEQ tokens, GRPO_NEW sampled tokens at
    temperature 1, kl_beta GRPO_KL_BETA, ``n_steps`` steps of ``run_rl``
    with the ``low_token`` reward (the slice warms up over 2 steps, so
    the first 2 steps do not depend on the step budget). Each rollout's
    decode, its scoring of the old log-probs and each update are counted
    apart. Checks: completions in vocab; rows right-padded with the mask
    on the completion only; every step's mean ratio within RATIO_TOL of 1
    with no clip; step 1's KL 0; no flash launch in any decode, every
    d128 kernel in each update. ``prompts``: drawn from ``gen`` when
    None. Returns (the launches by part, {"prompts", "tokens" and
    "history" a step, "peak_mem_gb", "gang"})."""
    from tpufw_torch import configs
    from tpufw_torch.ops import flash
    from tpufw_torch.train import GRPOConfig, GRPOTrainer
    from tpufw_torch.workloads.rl import resolve_reward

    cfg, tcfg = configs.llama3_8b_lora_train_slice(total_steps=n_steps)
    tcfg = dataclasses.replace(tcfg, batch_size=GRPO_PROMPTS * GRPO_GROUP,
                               seq_len=GRPO_SEQ, loss_chunk_size=GRPO_SEQ)
    trainer = GRPOTrainer(cfg, tcfg, device="cuda", grpo=GRPOConfig(
        group_size=GRPO_GROUP, max_new_tokens=GRPO_NEW, temperature=1.0,
        kl_beta=GRPO_KL_BETA))
    model = trainer.init_state(seed=0)
    before = _adapters_and_base(torch, model)
    if prompts is None:
        prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                                 device="cuda").tolist()
                   for n in GRPO_PROMPT_LENS]
    parts = {"decode": [], "score": [], "update": []}
    timing = {"score_s": []}
    batches = []

    def counted(name, fn, keep=None):
        def run(*a, **k):
            torch.cuda.synchronize()
            c0 = dict(flash.LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            if keep is not None:
                timing[keep].append(time.perf_counter() - t0)
            parts[name].append({k: flash.LAUNCHES[k] - c0[k]
                                for k in flash.LAUNCHES})
            return out
        return run

    score, rollout, step_fn = trainer._score, trainer.rollout, \
        trainer.train_step
    trainer._score = counted("score", score, "score_s")

    def rollout_counted(*a, **k):
        n0 = len(parts["score"])
        c0 = dict(flash.LAUNCHES)
        out = rollout(*a, **k)
        sc = parts["score"][n0]
        parts["decode"].append({k: flash.LAUNCHES[k] - c0[k] - sc[k]
                                for k in flash.LAUNCHES})
        return out

    def train_step(batch):
        batches.append(batch)
        return counted("update", step_fn)(batch)

    trainer.rollout = rollout_counted
    trainer.train_step = train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    history = trainer.run_rl(
        prompts, resolve_reward("low_token", cfg.vocab_size, GRPO_NEW),
        seed=0)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    trainer.optimizer = None
    moved = _only_adapters_moved(torch, model, before)
    rows_ok = []
    for b in batches:
        tiled = [q for q in prompts for _ in range(GRPO_GROUP)]
        for i, p in enumerate(tiled):
            n = len(p) + GRPO_NEW
            comp = b["tokens"][i, len(p):n]
            rows_ok.append(
                b["tokens"][i, :len(p)].tolist() == p
                and bool((comp >= 0).all() and (comp < cfg.vocab_size).all())
                and not b["tokens"][i, n:].any()
                and b["segment_ids"][i].tolist() == [1] * n + [0] * (
                    GRPO_SEQ - n)
                and b["loss_mask"][i].tolist() == [0.0] * len(p)
                + [1.0] * GRPO_NEW + [0.0] * (GRPO_SEQ - n))
    rows = GRPO_PROMPTS * GRPO_GROUP
    steps = [{k: h[k] for k in ("step", "reward_mean", "loss", "mean_ratio",
                                "clip_frac", "kl", "grad_norm", "rollout_s",
                                "update_s")} for h in history]
    decode_s = [h["rollout_s"] - s for h, s in zip(history,
                                                   timing["score_s"])]
    summary = {
        "steps": steps,
        "decode_ms": [1e3 * s for s in decode_s],
        "score_ms": [1e3 * s for s in timing["score_s"]],
        "update_ms": [1e3 * h["update_s"] for h in history],
        "decode_tokens_per_s": [rows * GRPO_NEW / s for s in decode_s],
        "update_tokens_per_s": [rows * (GRPO_SEQ - 1) / h["update_s"]
                                for h in history],
        "reward_mean": [h["reward_mean"] for h in history],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_by_part": {k: [sum(x.values()) for x in v]
                             for k, v in parts.items()},
        "rows": rows, "seq_len": GRPO_SEQ, "max_new_tokens": GRPO_NEW,
        "kl_beta": GRPO_KL_BETA, "reference": "the policy's base, adapters "
        "bypassed", "rows_right_padded_and_masked": all(rows_ok),
        "adapters": moved, "gang": trainer.gang, "device": kind,
        "nvidia_smi": smi}
    emit({"grpo_summary": summary})
    ref = {"prompts": prompts, "tokens": [b["tokens"] for b in batches],
           "history": history, "peak_mem_gb": summary["peak_mem_gb"],
           "gang": trainer.gang}
    del trainer, model, before, batches
    if len(history) != n_steps or not all(rows_ok):
        raise AssertionError(f"GRPO: {len(history)} steps, rows ok "
                             f"{sum(rows_ok)}/{len(rows_ok)}")
    for h in history:
        if not (abs(h["mean_ratio"] - 1.0) <= RATIO_TOL
                and h["clip_frac"] == 0.0 and math.isfinite(h["loss"])):
            raise AssertionError(f"GRPO ratio anchor: {h}")
    if history[0]["kl"] != 0.0:
        raise AssertionError(f"GRPO step 1 KL {history[0]['kl']} != 0")
    if any(sum(x.values()) for x in parts["decode"]):
        raise AssertionError(f"a flash kernel launched in a rollout's "
                             f"decode: {parts['decode']}")
    for x in parts["update"]:
        _d128_launches(flash, x)
    path = [flash.kernel_name(k, 128) for k in flash.KERNELS]
    return {part: {k: sum(x[k] for x in parts[part]) for k in path}
            for part in parts}, ref


def distill_check(torch, trainer, tokens) -> dict:
    """The chunked ``chunked_distill_loss`` on the card (bf16 head
    inputs, chunks of DISTILL_CHECK_CHUNK) against an unchunked plain
    computation of the same formula in fp32 on the same hidden states,
    on DISTILL_CHECK_TOKENS tokens: each of total, KL and CE within
    DISTILL_TOL relative."""
    from tpufw_torch.train.distill import chunked_distill_loss
    from tpufw_torch.train.trainer import forward_with_aux

    cfg = trainer.distill
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = torch.ones(targets.shape, device=tokens.device)
    with torch.no_grad():
        h_s, _ = forward_with_aux(trainer.model, inputs)
        h_t, _ = forward_with_aux(trainer.teacher, inputs)
        k_s, k_t = trainer.model.head_kernel(), trainer.teacher.head_kernel()
        got = chunked_distill_loss(
            h_s, k_s, h_t, k_t, targets, mask, cfg.temperature, cfg.alpha,
            chunk_size=DISTILL_CHECK_CHUNK, compute_dtype=torch.bfloat16)
        s = h_s.float() @ k_s.float()
        t = h_t.float() @ k_t.float()
        s_logp = torch.log_softmax(s / cfg.temperature, -1)
        t_logp = torch.log_softmax(t / cfg.temperature, -1)
        kl = cfg.temperature ** 2 * (t_logp.exp() * (t_logp - s_logp)).sum(
            -1).mean()
        ce = -torch.gather(torch.log_softmax(s, -1), -1,
                           targets[..., None])[..., 0].mean()
        want = (cfg.alpha * kl + (1 - cfg.alpha) * ce, kl, ce)
    out = {"check": "distill_chunked_vs_plain", "tokens": targets.shape[1],
           "tol": DISTILL_TOL}
    for name, g, w in zip(("total", "kl", "ce"), got, want):
        out[name] = [float(g), float(w)]
        out[name + "_rel"] = abs(float(g) - float(w)) / abs(float(w))
    return out


def distill_run(torch, kind, smi) -> dict:
    """13d: the student ``llama3_600m_bench`` (full size, full fine-tune;
    B=DISTILL_BATCH, seq 2048) distilled from a frozen bf16
    ``llama3_1b_proxy`` (16 layers, the same 32,768 vocab, drawn from
    seed 1) at T 2, alpha 0.5 for DISTILL_STEPS steps, counters zeroed
    just before. Checks: finite KL > 0 and CE; ``distill_check``; every
    d128 kernel launched. MFU adds the teacher's forward. Returns the
    launches."""
    from tpufw_torch import configs
    from tpufw_torch.models import PRESETS, model_for_config
    from tpufw_torch.ops import flash
    from tpufw_torch.train import (
        DistillConfig,
        DistillTrainer,
        TrainerConfig,
        synthetic_batches,
    )

    cfg = configs.bench_model_config()
    t_cfg = PRESETS["llama3_1b_proxy"]
    tcfg = TrainerConfig(batch_size=DISTILL_BATCH, seq_len=RESUME_SEQ,
                         total_steps=DISTILL_STEPS, warmup_steps=2,
                         loss_chunk_size=512)
    trainer = DistillTrainer(cfg, tcfg, device="cuda",
                             distill=DistillConfig(temperature=2.0,
                                                   alpha=0.5))
    trainer.init_state(seed=0)
    trainer.set_teacher(model_for_config(t_cfg, device="cuda", seed=1))
    gc.collect()
    torch.cuda.empty_cache()
    rec = _recorded(trainer, ("loss", "kl_loss", "ce_loss"))
    flops = (cfg.flops_per_token(RESUME_SEQ - 1)
             + t_cfg.flops_per_token(RESUME_SEQ - 1) / 3.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    history = trainer.run(
        synthetic_batches(DISTILL_BATCH, RESUME_SEQ, cfg.vocab_size, seed=0),
        model_flops_per_token=flops)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    metrics = _floats(rec)
    trainer.optimizer = None
    trainer.model.zero_grad(set_to_none=True)
    tokens = torch.as_tensor(next(synthetic_batches(
        1, DISTILL_CHECK_TOKENS + 1, cfg.vocab_size, seed=1))["tokens"],
        device="cuda").long()
    check = distill_check(torch, trainer, tokens)
    emit(check)
    summary = {"steps": len(history), "metrics": metrics, **_steady(history),
               "mfu_flops": "the student's 6N count plus the teacher's "
                            "forward, a third of its 6N count",
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "student": "llama3_600m_bench",
               "teacher": "llama3_1b_proxy", "teacher_dtype": "bfloat16",
               "teacher_params": t_cfg.n_params(), "params": cfg.n_params(),
               "batch_size": DISTILL_BATCH, "seq_len": RESUME_SEQ,
               "temperature": 2.0, "alpha": 0.5, "device": kind,
               "nvidia_smi": smi}
    emit({"distill_train_summary": summary})
    del trainer
    if len(history) != DISTILL_STEPS or not all(
            math.isfinite(m["loss"]) and m["kl_loss"] > 0
            and math.isfinite(m["ce_loss"]) for m in metrics):
        raise AssertionError(f"distillation: {metrics}")
    if not all(check[k + "_rel"] <= DISTILL_TOL for k in ("total", "kl",
                                                          "ce")):
        raise AssertionError(f"chunked distillation loss disagrees: {check}")
    return _d128_launches(flash, launches)


def embed_run(torch, recipe, data, kind, smi,
              steps=EMBED_STEPS) -> tuple[dict, dict]:
    """13e, one recipe of EMBED_RECIPES at all 32 layers with rank-16
    adapters: EMBED_PAIRS pairs (2 x EMBED_PAIRS rows) of EMBED_SEQ
    tokens through ``EmbeddingTrainer.run`` for ``steps`` of an
    EMBED_STEPS-step schedule, counters zeroed just before. Checks:
    finite InfoNCE losses; every d128 kernel launched; ``embed`` gives
    unit-norm [N, D] vectors (in a gang it refuses: one process's
    surface); a changed last token moves the first position's hidden
    state under the bidirectional trunk and not under the causal one;
    ``evaluate_retrieval`` runs. Returns (the launches, {"metrics" a
    step, "history", "peak_mem_gb"})."""
    import itertools

    from tpufw_torch.models import PRESETS
    from tpufw_torch.ops import flash
    from tpufw_torch.train import ContrastiveConfig, EmbeddingTrainer
    from tpufw_torch.train import TrainerConfig
    from tpufw_torch.train.contrastive import _fit, pair_batches
    from tpufw_torch.train.sft import byte_encode
    from tpufw_torch.train.trainer import forward_with_aux
    from tpufw_torch.workloads.embed import embed_flops_per_token

    preset, causal, pooling, temp = EMBED_RECIPES[recipe]
    cfg = dataclasses.replace(PRESETS[preset], lora_rank=16, lora_alpha=16.0,
                              causal=causal)
    if not causal:
        cfg = dataclasses.replace(cfg, sliding_window=None)
    tcfg = TrainerConfig(batch_size=2 * EMBED_PAIRS, seq_len=EMBED_SEQ,
                         total_steps=EMBED_STEPS, warmup_steps=1)
    trainer = EmbeddingTrainer(cfg, tcfg, device="cuda",
                               contrastive=ContrastiveConfig(
                                   temperature=temp, pooling=pooling))
    model = trainer.init_state(seed=0)
    rec = _recorded(trainer, ("loss", "grad_norm", "accuracy", "sim_pos",
                              "sim_neg"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    history = trainer.run(
        itertools.islice(pair_batches(data["embed"], EMBED_PAIRS, EMBED_SEQ,
                                      byte_encode), steps),
        model_flops_per_token=embed_flops_per_token(cfg, EMBED_SEQ))
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ref = {"metrics": _floats(rec), "history": history, "peak_mem_gb": peak}
    trainer.optimizer = None
    model.zero_grad(set_to_none=True)
    import numpy as np

    toks, seg = _fit(byte_encode("what is a retrieval encoder?"), EMBED_SEQ)
    if trainer.gang:
        try:
            trainer.embed(toks[None], seg[None])
        except NotImplementedError:
            pass
        else:
            raise AssertionError("embed() ran in a gang")
        summary = {"recipe": recipe, "gang": True, "steps": len(history),
                   "losses": [m.loss for m in history],
                   "peak_mem_gb": peak, "launches": launches,
                   "embed_refused_in_gang": True, "device": kind,
                   "nvidia_smi": smi}
        emit({"embed_train_summary": summary})
        del trainer, model
        if len(history) != steps or not all(
                math.isfinite(m.loss) for m in history):
            raise AssertionError(f"embeddings {recipe}: {summary['losses']}")
        return _d128_launches(flash, launches), ref
    emb = trainer.embed(np.stack([toks, toks]), np.stack([seg, seg]))
    norms = np.linalg.norm(emb, axis=-1)
    x = torch.as_tensor(toks[None], device="cuda").long()
    y = x.clone()
    y[0, -1] = (int(y[0, -1]) + 7) % cfg.vocab_size
    with torch.no_grad():
        moved0 = float((forward_with_aux(model, x)[0][0, 0]
                        - forward_with_aux(model, y)[0][0, 0]).abs().max())
    retrieval = trainer.evaluate_retrieval(data["embed"], byte_encode)
    summary = {"recipe": recipe, "model": preset, "causal": causal,
               "pooling": pooling, "temperature": temp,
               "steps": len(history), "losses": [m.loss for m in history],
               **_steady(history),
               "mfu_flops": "the Meter's 6N count of the base less the LM "
                            "head's, the scores of a bidirectional trunk "
                            "in full",
               "peak_mem_gb": peak, "launches": launches,
               "rows": 2 * EMBED_PAIRS, "seq_len": EMBED_SEQ,
               "n_layers": cfg.n_layers, "lora_rank": cfg.lora_rank,
               "embed_shape": list(emb.shape),
               "embed_norm_max_dev": float(np.abs(norms - 1.0).max()),
               "first_position_moved_by_last_token": moved0,
               "retrieval": retrieval, "device": kind, "nvidia_smi": smi}
    emit({"embed_train_summary": summary})
    del trainer, model
    if len(history) != steps or not all(
            math.isfinite(m.loss) for m in history):
        raise AssertionError(f"embeddings {recipe}: {summary['losses']}")
    if emb.shape != (2, cfg.d_model) or not np.allclose(norms, 1.0,
                                                          atol=1e-5):
        raise AssertionError(f"embed(): shape {emb.shape}, norms {norms}")
    if (moved0 > 0) == causal:
        raise AssertionError(f"{recipe}: causal={causal} but the first "
                             f"position moved by {moved0}")
    return _d128_launches(flash, launches), ref


def post_train_phase(torch, kind, smi, gen) -> dict:
    """Phase 13: post-training, 13a SFT, 13b DPO, 13c GRPO (the three on
    ``llama3_8b_lora_train_slice``), 13d distillation (the 600m student,
    the 1b proxy teacher) and 13e the two embedding recipes, each with
    its models freed before the next. Data files are written to a
    gitignored directory of the checkout, deleted after. Returns
    ({sub-phase: {kernel: launches}} of the d128 kernels, the GRPO and
    embedding runs' references for phase 17)."""
    emit({"phase13_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE),
          "card_state_query": CARD_STATE})
    workdir = os.path.join(ROOT, "build-torch", f"phase13-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    out, refs = {}, {}

    def sub(name, fn):
        try:
            return _timed(name, fn)
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    try:
        data = post_train_data(workdir)
        out["sft"] = sub("13a", lambda: sft_run(torch, data, kind, smi))
        out["dpo"] = sub("13b", lambda: dpo_run(torch, data, kind, smi))
        parts, refs["grpo"] = sub("13c", lambda: grpo_run(
            torch, kind, smi, gen))
        for part, counts in parts.items():
            out["grpo_" + part] = counts
        out["distill"] = sub("13d", lambda: distill_run(torch, kind, smi))
        for i, recipe in enumerate(EMBED_RECIPES):
            out["embed_" + recipe], refs["embed_" + recipe] = sub(
                f"13e{i + 1}", lambda r=recipe: embed_run(torch, r, data,
                                                          kind, smi))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase13_card_state_at_end": nvidia_smi(CARD_STATE)})
    return out, refs


# ---------------------------------------------------------- phase 14


def _rel_diff(a, b) -> float:
    """The largest |a - b| / |b| over two lists of numbers."""
    return max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)),
               default=0.0)


def _mesh_run(torch, trainer, batches, flops, on_metrics=None,
              shutdown=None):
    """(history, [(loss, grad_norm)] a step, flash launches, peak GB) of
    ``trainer.run`` over ``batches``, launch counters zeroed just before."""
    from tpufw_torch.ops import flash

    rec = _recorded(trainer, ("loss", "grad_norm"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    history = trainer.run(iter(batches), model_flops_per_token=flops,
                          on_metrics=on_metrics, shutdown=shutdown)
    torch.cuda.synchronize()
    launches = {flash.kernel_name(k, 128): flash.LAUNCHES[
        flash.kernel_name(k, 128)] for k in flash.KERNELS}
    pairs = [(float(r["loss"]), float(r["grad_norm"])) for r in rec]
    return history, pairs, launches, torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def _all_reduce_log():
    """Inside: every ``torch.distributed.all_reduce`` call's (device
    type, dtype, op) appended to the yielded list."""
    import torch.distributed as dist

    real, calls = dist.all_reduce, []

    def logged(t, op=dist.ReduceOp.SUM, **kw):
        calls.append((t.device.type, str(t.dtype), str(op)))
        return real(t, op=op, **kw)

    dist.all_reduce = logged
    try:
        yield calls
    finally:
        dist.all_reduce = real


def mesh_600m(torch, kind, smi) -> dict:
    """14a, its first half, before any process group: ``llama3_600m_bench``
    at full size (B=RESUME_BATCH, seq RESUME_SEQ, remat ``dots``) for
    MESH_STEPS steps through the unwrapped Trainer. Returns what the
    sharded half (``mesh_600m_sharded``) holds its runs against: the
    batches, a maker of trainers, the flops, and the run's history,
    (loss, grad_norm) a step, launches and peak memory."""
    import torch.distributed as dist

    from tpufw_torch.configs import bench_model_config
    from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches

    cfg = bench_model_config()
    tcfg = TrainerConfig(batch_size=RESUME_BATCH, seq_len=RESUME_SEQ,
                         total_steps=MESH_STEPS, warmup_steps=2, log_every=1,
                         loss_chunk_size=512, handle_preemption=False)
    it = synthetic_batches(RESUME_BATCH, RESUME_SEQ, cfg.vocab_size, seed=14)
    batches = [next(it) for _ in range(MESH_STEPS)]
    flops = cfg.flops_per_token(RESUME_SEQ - 1)

    def trainer(**kw):
        return Trainer(cfg, dataclasses.replace(tcfg, **kw), device="cuda")

    emit({"train": "llama3_600m_bench mesh", "params": cfg.n_params(),
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "batch_size": RESUME_BATCH, "seq_len": RESUME_SEQ,
          "remat_policy": cfg.remat_policy, "steps": MESH_STEPS,
          "mesh": "world-1 NCCL group, MeshConfig() (fsdp fills)"})
    if dist.is_initialized():
        raise AssertionError("14a: the unwrapped run must see no group")
    plain = trainer()
    plain.init_state(seed=0)
    h_u, want, launches_u, peak_u = _mesh_run(torch, plain, batches, flops)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"h_u": h_u, "want": want, "launches_u": launches_u,
            "peak_u": peak_u, "batches": batches, "trainer": trainer,
            "flops": flops}


def mesh_600m_sharded(torch, kind, smi, unwrapped) -> dict:
    """14a's second half, under the world-1 NCCL group: the same
    MESH_STEPS steps through the sharded Trainer from the same seed on
    the same batches, losses and grad norms within MESH_TOL relative of
    the unwrapped run's (bit-equal expected) and the flash launches
    equal; then a sharded run whose stop is request()ed after step 1
    (should_stop's all-reduce MAX of an int32 on the card), its forced
    checkpoint, and a sharded resume whose next (loss, grad_norm) is
    bit-equal to the unbroken sharded run's step 2. Returns the sharded
    run's launches; raises AssertionError."""
    import torch.distributed as dist

    from tpufw_torch.train.checkpoint import CheckpointManager
    from tpufw_torch.train.preemption import GracefulShutdown

    batches, trainer = unwrapped["batches"], unwrapped["trainer"]
    flops = unwrapped["flops"]
    sharded = trainer()
    if not sharded.gang:
        raise AssertionError("14a: the trainer did not shard")
    mesh = dict(zip(sharded.mesh.mesh_dim_names, sharded.mesh.shape))
    sharded.init_state(seed=0)
    h_s, got, launches_s, peak_s = _mesh_run(torch, sharded, batches, flops)
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    want = unwrapped["want"]
    diff_loss = _rel_diff([g[0] for g in got], [w[0] for w in want])
    diff_norm = _rel_diff([g[1] for g in got], [w[1] for w in want])
    check = {"check": "mesh_600m_sharded_vs_unwrapped", "mesh": mesh,
             "losses_sharded": [g[0] for g in got],
             "losses_unwrapped": [w[0] for w in want],
             "grad_norms_sharded": [g[1] for g in got],
             "grad_norms_unwrapped": [w[1] for w in want],
             "bit_equal": got == want, "max_rel_diff_loss": diff_loss,
             "max_rel_diff_grad_norm": diff_norm, "tol": MESH_TOL,
             "launches_sharded": launches_s,
             "launches_unwrapped": unwrapped["launches_u"]}
    emit(check)
    if len(got) != MESH_STEPS or max(diff_loss, diff_norm) > MESH_TOL:
        raise AssertionError(f"14a: sharded and unwrapped differ: {check}")
    if launches_s != unwrapped["launches_u"] or not all(launches_s.values()):
        raise AssertionError(f"14a: launches differ: {check}")

    # The gang's stop: request() after step 1, should_stop's all-reduce
    # on the card, the forced checkpoint, a sharded resume.
    workdir = os.path.join(ROOT, "build-torch", f"phase14-{os.getpid()}")
    try:
        stopped = trainer(checkpoint_dir=workdir, checkpoint_every=1000)
        stopped.init_state(seed=0)
        sd = GracefulShutdown(signals=())
        with _all_reduce_log() as calls:
            _, cut, _, _ = _mesh_run(torch, stopped, batches, flops,
                                     on_metrics=lambda m: sd.request(),
                                     shutdown=sd)
        saves = stopped.checkpointer.saves
        del stopped
        gc.collect()
        torch.cuda.empty_cache()
        stop_reduces = [c for c in calls if c[1] == "torch.int32"]
        steps_on_disk = CheckpointManager(workdir).all_steps()
        resumed = trainer(checkpoint_dir=workdir)
        t0 = time.perf_counter()
        restored = resumed.maybe_restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        _, after, _, _ = _mesh_run(torch, resumed, batches[1:2], flops)
        del resumed
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    stop = {"check": "mesh_600m_gang_stop", "steps_before_stop": len(cut),
            "stop_all_reduces": stop_reduces, "checkpoints": steps_on_disk,
            "restored": restored, "save": saves, "restore_s": restore_s,
            "resumed_loss": after[0][0] if after else None,
            "unbroken_loss": got[1][0],
            "resumed_bit_equal": bool(after) and after[0] == got[1]}
    emit(stop)
    if not (len(cut) == 1 and steps_on_disk == [1] and restored
            and stop["resumed_bit_equal"]
            and ("cuda", "torch.int32", str(dist.ReduceOp.MAX))
            in stop_reduces):
        raise AssertionError(f"14a: the gang's stop failed: {stop}")
    summary = {"model": "llama3_600m_bench", "mesh": mesh,
               "sharded": _steady(h_s), "unwrapped": _steady(unwrapped["h_u"]),
               "step_ms_sharded": [1e3 * m.step_time_s for m in h_s],
               "step_ms_unwrapped": [1e3 * m.step_time_s
                                     for m in unwrapped["h_u"]],
               "peak_mem_gb_sharded": peak_s,
               "peak_mem_gb_unwrapped": unwrapped["peak_u"],
               "launches": launches_s,
               "card_state": nvidia_smi(CARD_STATE),
               "card_state_query": CARD_STATE,
               "device": kind, "nvidia_smi": smi}
    emit({"mesh_train_summary": summary})
    return launches_s


def mesh_lora(torch, kind, smi, lora_losses) -> dict:
    """14b: ``llama3_8b_lora_train_slice`` (all 32 layers, rank 16)
    sharded under the world-1 NCCL group for MESH_LORA_STEPS steps from
    phase 11a's seed on 11a's batches: the losses within MESH_TOL of
    11a's unwrapped ones (bit-equal expected), the base unchanged and
    every adapter moved. Returns the launches; raises AssertionError."""
    import itertools

    from tpufw_torch import configs
    from tpufw_torch.train import Trainer, synthetic_batches

    cfg, tcfg = configs.llama3_8b_lora_train_slice(total_steps=LORA_STEPS)
    trainer = Trainer(cfg, tcfg, device="cuda")
    model = trainer.init_state(seed=0)
    before = _adapters_and_base(torch, model)
    batches = list(itertools.islice(synthetic_batches(
        tcfg.batch_size, tcfg.seq_len, cfg.vocab_size, seed=0),
        MESH_LORA_STEPS))
    history, got, launches, peak = _mesh_run(
        torch, trainer, batches, cfg.flops_per_token(tcfg.seq_len - 1))
    moved = _only_adapters_moved(torch, model, before)
    losses = [g[0] for g in got]
    want = lora_losses[:MESH_LORA_STEPS]
    diff = _rel_diff(losses, want)
    summary = {"model": "llama3_8b_lora", "n_layers": cfg.n_layers,
               "lora_rank": cfg.lora_rank, "gang": trainer.gang,
               "losses_sharded": losses, "losses_unwrapped_11a": want,
               "bit_equal": losses == want, "max_rel_diff_loss": diff,
               "tol": MESH_TOL,
               "step_ms": [1e3 * m.step_time_s for m in history],
               "peak_mem_gb": peak, "launches": launches, **moved,
               "card_state": nvidia_smi(CARD_STATE),
               "device": kind, "nvidia_smi": smi}
    emit({"mesh_lora_train_summary": summary})
    del trainer, model, before
    gc.collect()
    torch.cuda.empty_cache()
    if not summary["gang"] or len(losses) != MESH_LORA_STEPS \
            or diff > MESH_TOL:
        raise AssertionError(f"14b: {summary}")
    if not all(launches.values()):
        raise AssertionError(f"14b: a kernel was not launched: {launches}")
    return launches


def mesh_phase(torch, kind, smi, lora_losses) -> dict:
    """Phase 14: the mesh on the card. 14a's unwrapped run, then a
    world-1 NCCL group on this card (``cluster.init_process_group`` on a
    localhost ``TCPStore``: ``initialize_cluster`` is a no-op for one
    process, as ``tpufw``'s), 14a's sharded runs and 14b, then the group
    is destroyed. Returns {"600m": launches, "lora": launches}."""
    import torch.distributed as dist

    from tpufw_torch.cluster import init_process_group

    emit({"phase14_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    unwrapped = _timed("14a_unwrapped", lambda: mesh_600m(torch, kind, smi))
    init_process_group(f"127.0.0.1:{_free_port()}", 1, 0,
                       torch.device("cuda", 0))
    try:
        out = {"600m": _timed("14a", lambda: mesh_600m_sharded(
            torch, kind, smi, unwrapped))}
        del unwrapped
        gc.collect()
        torch.cuda.empty_cache()
        out["lora"] = _timed("14b", lambda: mesh_lora(torch, kind, smi,
                                                      lora_losses))
    finally:
        dist.destroy_process_group()
    emit({"phase14_card_state_at_end": nvidia_smi(CARD_STATE)})
    return out


def _ring_inputs(torch, gen, b, t, h, kh, d, scale=1.0, pad_v=0,
                 seg_lens=None):
    """bf16 q, k, v (V's last ``pad_v`` columns zero, as MLA pads it) and
    dO on the card, and the [B, T] segment ids of ``seg_lens`` (or None)."""
    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * s).to(
            torch.bfloat16)

    q, k = randn(b, t, h, d, s=scale), randn(b, t, kh, d, s=scale)
    v, do = randn(b, t, kh, d), randn(b, t, h, d)
    if pad_v:
        v[..., d - pad_v:] = 0
    seg = None
    if seg_lens is not None:
        seg = torch.cat([torch.full((n,), i + 1, dtype=torch.int32)
                         for i, n in enumerate(seg_lens)])
        seg = seg.to("cuda")[None].expand(b, t).contiguous()
    return q, k, v, do, seg


def _fwd_bwd(torch, fn, q, k, v, do):
    """(O, dQ, dK, dV) of ``fn`` on leaf copies of q, k, v and dO."""
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(qs, ks, vs)
    out.backward(do)
    return out.detach(), qs.grad, ks.grad, vs.grad


def _expected_chunks(n, l, window) -> dict:
    """The ring-flash launches of one forward and backward by chunk case:
    every live step's full and diagonal chunks (``_n_live_steps``)."""
    from tpufw_torch.parallel.ring_flash import _n_live_steps

    steps = _n_live_steps(n, l, window)
    full = sum(1 for s in range(steps) for i in range(n) if 0 < s <= i)
    diag = n
    return {"fwd_full": full, "fwd_diag": diag, "bwd_full": full,
            "bwd_diag": diag}


def ring_case(torch, gen, name, impl, n, b, t, h, kh, d, masks, reps,
              scale=1.0, pad_v=0, seg_lens=None, plain=False):
    """One 15a case: ``impl`` ("ring" ring-flash or "ulysses") over a
    one-process ring of ``n`` shards on bf16 inputs, forward and backward,
    against whole-sequence ``flash_attention`` (the kernels): O, dQ, dK,
    dV each within ROW_TOL of each row's largest value. With ``plain``,
    against ``xla_attention`` on fp32 copies instead: O within ROW_TOL a
    row, every part within FRO_TOL (Frobenius), and each gradient's row
    error at most ROW_TOL above whole-sequence flash's own against the
    same reference (flash's Δ comes from its bf16 O, so rows whose dQ
    cancels to near zero are off for both alike). Launches counted on the
    checked run; forward and forward+backward ms of both beside. Returns
    the run's flash launches; raises AssertionError."""
    from tpufw_torch.ops import flash
    from tpufw_torch.ops.attention import xla_attention
    from tpufw_torch.parallel import (
        LocalSequenceGroup,
        ring_attention,
        ulysses_attention,
    )
    from tpufw_torch.parallel import ring_flash

    q, k, v, do, seg = _ring_inputs(torch, gen, b, t, h, kh, d, scale, pad_v,
                                    seg_lens)
    kw = dict(segment_ids=seg, logits_soft_cap=masks.get("soft_cap"),
              sliding_window=masks.get("window"))
    group = LocalSequenceGroup(n)
    if impl == "ring":
        def run(q, k, v):
            return ring_attention(q, k, v, mesh=group, impl="flash", **kw)
    else:
        def run(q, k, v):
            return ulysses_attention(q, k, v, mesh=group, backend="flash",
                                     **kw)

    def whole(q, k, v):
        return flash.flash_attention(q, k, v, **kw)

    torch.cuda.synchronize()
    flash.reset_launch_counts()
    ring_flash.reset_chunk_launches()
    got = _fwd_bwd(torch, run, q, k, v, do)
    torch.cuda.synchronize()
    launches = {k_: c for k_, c in flash.LAUNCHES.items() if c}
    chunks = dict(ring_flash.CHUNK_LAUNCHES)
    parts = ("o", "dq", "dk", "dv")
    whole_errs = None
    if plain:
        ref = _fwd_bwd(torch, lambda *x: xla_attention(*x, **kw), q.float(),
                       k.float(), v.float(), do.float())
        reference = "xla_attention, whole sequence, fp32"
        whole_errs = {part: kernel_errors(torch, x, want) for part, x, want
                      in zip(parts, _fwd_bwd(torch, whole, q, k, v, do), ref)}
    else:
        ref = _fwd_bwd(torch, whole, q, k, v, do)
        reference = "flash_attention, whole sequence (the kernels)"
    errs = {}
    for part, x, want in zip(parts, got, ref):
        if not torch.isfinite(x).all():
            raise AssertionError(f"15a {name}: {part} has non-finite values")
        errs[part] = kernel_errors(torch, x, want)
    want_chunks = (_expected_chunks(n, t // n, masks.get("window"))
                   if impl == "ring" else
                   {k_: 0 for k_ in chunks})
    with torch.no_grad():
        ms = {"ring_fwd": cuda_ms(torch, lambda: run(q, k, v), reps),
              "whole_flash_fwd": cuda_ms(torch, lambda: whole(q, k, v), reps)}
    ms["ring_fwd_bwd"] = cuda_ms(
        torch, lambda: _fwd_bwd(torch, run, q, k, v, do), reps)
    ms["whole_flash_fwd_bwd"] = cuda_ms(
        torch, lambda: _fwd_bwd(torch, whole, q, k, v, do), reps)
    ms["ring_bwd"] = ms["ring_fwd_bwd"] - ms["ring_fwd"]
    ms["whole_flash_bwd"] = ms["whole_flash_fwd_bwd"] - ms["whole_flash_fwd"]
    if plain:
        bad = [p for p, e in errs.items() if e["fro"] > FRO_TOL or e["row"] > (
            ROW_TOL if p == "o" else whole_errs[p]["row"] + ROW_TOL)]
    else:
        bad = [p for p, e in errs.items() if e["row"] > ROW_TOL]
    emit({"check": f"sequence_15a_{name}", "impl": impl, "shards": n,
          "shape": [b, t, h, kh, d], "masks": masks,
          "segments": list(seg_lens) if seg_lens else None,
          "v_zero_columns": pad_v, "reference": reference, "errors": errs,
          "whole_flash_errors": whole_errs,
          "tol": {"row": ROW_TOL, "row_floor": ROW_FLOOR}
          | ({"fro": FRO_TOL} if plain else {}),
          "launches": launches, "launches_by_chunk": chunks,
          "launches_by_chunk_expected": want_chunks, "ms": ms,
          "card_state": nvidia_smi(CARD_STATE)})
    if bad:
        raise AssertionError(f"15a {name}: {bad} past {ROW_TOL}")
    if chunks != want_chunks:
        raise AssertionError(f"15a {name}: chunk launches {chunks}, "
                             f"expected {want_chunks}")
    return launches


# 15a's cases: name -> (impl, shards, b, t, heads, kv heads, head dim,
# masks, extra). Llama-3-8B attention at 16,384 tokens; packed segments
# whose third starts in shard 2, so shard 3's rows of it see no key of
# chunk 0; Gemma-2-9B at 8,192, global and windowed (3 of 4 live steps);
# deepseek_mla_bench at B=8 x 4,096 with V zero-padded; Ulysses at
# Llama's shapes; and the small case of every mask at once, against the
# plain reference in fp32 (a cap of 5, which unit-scale logits reach).
# Inputs at unit scale: larger ones make the softmax so peaked that dQ's
# rows cancel to near zero, and bf16 noise, whole-sequence flash's own
# against fp32 included, then dominates those rows.
SEQ_CASES = {
    "d128_llama3_8b_causal": ("ring", 4, 1, 16384, 32, 8, 128,
                              {"causal": True}, {}),
    "d128_llama3_8b_segments": ("ring", 4, 1, 16384, 32, 8, 128,
                                {"causal": True},
                                {"seg_lens": (3000, 7000, 6384)}),
    "d256_gemma2_9b_cap50": ("ring", 4, 1, 8192, 16, 8, 256,
                             {"causal": True, "soft_cap": GEMMA_ATTN_CAP}, {}),
    "d256_gemma2_9b_cap50_window4096": (
        "ring", 4, 1, 8192, 16, 8, 256,
        {"causal": True, "soft_cap": GEMMA_ATTN_CAP, "window": GEMMA_WINDOW},
        {}),
    "d192_mla_padded_v": ("ring", 2, 8, 4096, 16, 16, 192, {"causal": True},
                          {"pad_v": 64}),
    "d128_ulysses_llama3_8b": ("ulysses", 4, 1, 16384, 32, 8, 128,
                               {"causal": True}, {}),
    "d128_small_segments_cap_window_vs_plain": (
        "ring", 4, 2, 1024, 4, 2, 128,
        {"causal": True, "soft_cap": 5.0, "window": 300},
        {"seg_lens": (200, 500, 324), "plain": True}),
}


def sequence_rings(torch, gen) -> dict:
    """15a: every SEQ_CASES case. Returns the flash launches summed over
    the checked ring runs, by kernel."""
    from tpufw_torch.ops import flash

    total = {name: 0 for name in flash.LAUNCHES}
    for name, (impl, n, b, t, h, kh, d, masks, extra) in SEQ_CASES.items():
        for k_, c in ring_case(torch, gen, name, impl, n, b, t, h, kh, d,
                               masks, 3, **extra).items():
            total[k_] += c
        gc.collect()
        torch.cuda.empty_cache()
    emit({"sequence_summary": "15a", "cases": list(SEQ_CASES),
          "launches": total})
    return total


def sequence_entry(torch, kind, smi) -> dict:
    """15b: ``train_llama.build_trainer`` (the workload's entry) in a
    world-1 NCCL group with TPUFW_ATTENTION flash, then ring, then
    ulysses: ``llama3_600m_bench`` at full size (B=RESUME_BATCH x
    RESUME_SEQ, remat dots), MESH_STEPS steps from seed 0 on the same
    batches. ring and ulysses run on a sequence ring of one shard: their
    losses and grad norms within MESH_TOL of flash's (bit-equal
    expected), their launches equal to flash's. Returns the launches by
    backend."""
    import torch.distributed as dist

    from tpufw_torch.cluster import init_process_group
    from tpufw_torch.train import synthetic_batches
    from tpufw_torch.workloads import train_llama

    env = dict(model="llama3_600m_bench", batch_size=RESUME_BATCH,
               seq_len=RESUME_SEQ, total_steps=MESH_STEPS, warmup_steps=2,
               loss_chunk_size=512, handle_preemption=0, device="cuda",
               log_every=1)
    init_process_group(f"127.0.0.1:{_free_port()}", 1, 0,
                       torch.device("cuda", 0))
    runs = {}
    try:
        batches = None
        for backend in ("flash", "ring", "ulysses"):
            with _Env(attention=backend, **env):
                trainer, cfg = train_llama.build_trainer()
            if batches is None:
                it = synthetic_batches(RESUME_BATCH, RESUME_SEQ,
                                       cfg.vocab_size, seed=15)
                batches = [next(it) for _ in range(MESH_STEPS)]
            mesh = dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
            trainer.init_state(seed=0)
            hist, pairs, launches, peak = _mesh_run(
                torch, trainer, batches, cfg.flops_per_token(RESUME_SEQ - 1))
            runs[backend] = {"pairs": pairs, "launches": launches,
                             "peak_gb": peak, "mesh": mesh,
                             "step_ms": [1e3 * m.step_time_s for m in hist]}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    want = runs["flash"]
    bad = []
    for backend in ("ring", "ulysses"):
        got = runs[backend]
        d_loss = _rel_diff([g[0] for g in got["pairs"]],
                           [w[0] for w in want["pairs"]])
        d_norm = _rel_diff([g[1] for g in got["pairs"]],
                           [w[1] for w in want["pairs"]])
        got |= {"bit_equal": got["pairs"] == want["pairs"],
                "max_rel_diff_loss": d_loss, "max_rel_diff_grad_norm": d_norm}
        if (len(got["pairs"]) != MESH_STEPS
                or max(d_loss, d_norm) > MESH_TOL
                or got["launches"] != want["launches"]
                or not all(got["launches"].values())):
            bad.append(backend)
    emit({"sequence_summary": "15b", "model": "llama3_600m_bench",
          "batch_size": RESUME_BATCH, "seq_len": RESUME_SEQ,
          "steps": MESH_STEPS, "tol": MESH_TOL,
          "group": "world-1 NCCL, TPUFW_MESH_SEQUENCE unset (one shard)",
          "card_state": nvidia_smi(CARD_STATE)}
         | {b_: {"losses": [p[0] for p in r["pairs"]],
                 "grad_norms": [p[1] for p in r["pairs"]]}
            | {k_: v_ for k_, v_ in r.items() if k_ != "pairs"}
            for b_, r in runs.items()})
    if bad:
        raise AssertionError(f"15b: {bad} differ from flash")
    return {b_: r["launches"] for b_, r in runs.items()}


def sequence_phase(torch, kind, smi, gen) -> dict:
    """Phase 15: sequence parallelism on the card (15a, 15b). Returns
    {"15a": launches, "15b_ring": ..., "15b_ulysses": ...} by kernel."""
    emit({"phase15_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    out = {"15a": _timed("15a", lambda: sequence_rings(torch, gen))}
    gc.collect()
    torch.cuda.empty_cache()
    entry = _timed("15b", lambda: sequence_entry(torch, kind, smi))
    out |= {f"15b_{b_}": entry[b_] for b_ in ("ring", "ulysses")}
    return out


# Phase 16: pipeline parallelism on one card (a LocalPipeGroup of two
# stages in one process). Steps after the warm-up one, microbatches, the
# gate against GPipe and the oracle, the MLA batch.
PIPE_STEPS = 3
PIPE_M = 4
PIPE_TOL = 1e-3
PIPE_MLA_BATCH = 8
# Flash launches a layer a microbatch, (forward, dQ, dK/dV), from the code:
# GPipe runs each layer's forward once and autograd its backward once (no
# stage remat); 1F1B and interleaved run it under no_grad, then again from
# the stash for the backward; ZB-H1's B recomputes it for the input
# gradient and W again for the weight gradient, each with the attention's
# backward (both need dQ, dK and dV).
PIPE_PER_LAYER = {"gpipe": (1, 1, 1), "1f1b": (2, 1, 1),
                  "interleaved": (2, 1, 1), "zb1": (3, 2, 2)}
# Sub-phases: name, (model, batch, [(schedule, n_virtual)]); interleaved
# at v = 7, the one v >= 2 with 14 % (2v) == 0.
PIPE_CASES = {
    "16a": ("llama3_600m_bench", RESUME_BATCH,
            [("gpipe", 1), ("1f1b", 1), ("zb1", 1), ("interleaved", 7)]),
    "16b": ("deepseek_mla_bench", PIPE_MLA_BATCH,
            [("gpipe", 1), ("1f1b", 1)]),
}


def pipeline_oracle_loss(torch, params, batch, cfg) -> float:
    """The LM loss of ``batch`` through ``reference_forward`` (the
    sequential oracle, the same flash backend, row by row), under
    no_grad: the mean token CE with z-loss over the shifted targets."""
    from tpufw_torch.ops.loss import token_cross_entropy
    from tpufw_torch.parallel.pipeline import reference_forward

    tokens = torch.from_numpy(batch["tokens"]).to("cuda")
    total, n = 0.0, 0
    with torch.no_grad():
        for r in range(tokens.shape[0]):
            logits = reference_forward(params, tokens[r:r + 1, :-1], cfg,
                                       backend=cfg.attention_backend)
            ce = token_cross_entropy(logits, tokens[r:r + 1, 1:])
            total += float(ce.sum())
            n += ce.numel()
            del logits, ce
    return total / n


def pipeline_run(torch, name, model, cfg, batch, schedule, v, batches):
    """One schedule of a phase-16 sub-phase: ``PipelineTrainer`` over a
    ``LocalPipeGroup(2)`` from seed 0, 1 + PIPE_STEPS steps on
    ``batches``, the flash counters zeroed just before the run and read
    just after. GPipe's run first computes the oracle's loss on the same
    weights and batch. Returns its summary."""
    from tpufw_torch.ops import flash
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer, TrainerConfig

    pipe = PipelineConfig(2, PIPE_M, schedule, v)
    tcfg = TrainerConfig(batch_size=batch, seq_len=RESUME_SEQ,
                         total_steps=1 + PIPE_STEPS, warmup_steps=2,
                         log_every=1, loss_chunk_size=512,
                         handle_preemption=False)
    trainer = PipelineTrainer(cfg, pipe, tcfg, device="cuda")
    trainer.init_state(seed=0)
    oracle = (pipeline_oracle_loss(torch, trainer.params, batches[0], cfg)
              if schedule == "gpipe" else None)
    rec = _recorded(trainer, ("loss", "grad_norm"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    hist = trainer.run(iter(batches),
                       model_flops_per_token=cfg.flops_per_token(
                           RESUME_SEQ - 1))
    torch.cuda.synchronize()
    d = head_dim_of(cfg)
    launches = {flash.kernel_name(k, d): flash.LAUNCHES[flash.kernel_name(
        k, d)] for k in flash.KERNELS}
    others = {k_: c for k_, c in flash.LAUNCHES.items()
              if k_ not in launches and c}
    per_layer = PIPE_PER_LAYER[schedule]
    steps = len(hist)
    predicted = {flash.kernel_name(k, d): steps * cfg.n_layers * PIPE_M * n
                 for k, n in zip(flash.KERNELS, per_layer)}
    pairs = [(float(r["loss"]), float(r["grad_norm"])) for r in rec]
    step_ms = [1e3 * m.step_time_s for m in hist[1:]]
    out = {"pipeline_summary": name, "model": model, "schedule": schedule,
           "n_virtual": v, "stages": 2, "microbatches": PIPE_M,
           "batch_size": batch, "seq_len": RESUME_SEQ,
           "group": "LocalPipeGroup(2): both stages in this process",
           "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms) if step_ms else None,
           "tokens_per_sec": [m.tokens_per_sec_per_gpu for m in hist[1:]],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": [p[0] for p in pairs],
           "grad_norms": [p[1] for p in pairs],
           "launches": launches, "predicted_launches": predicted,
           "other_launches": others,
           "bubble_fraction": pipe.bubble_fraction(),
           "n_ticks": pipe.n_ticks(), "oracle_loss": oracle}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_phase(torch, kind, smi) -> dict:
    """Phase 16: each PIPE_CASES sub-phase's schedules at full size
    (``pipeline_run``). Step 0's loss and grad norm of every schedule
    within PIPE_TOL relative of GPipe's, GPipe's loss within PIPE_TOL of
    the oracle's, every loss finite, every launch count equal to its
    prediction and no other kernel launched. Returns {"<sub>_<schedule>":
    launches by kernel}; raises AssertionError."""
    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.train import synthetic_batches

    from tpufw_torch.ops import flash

    emit({"phase16_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    # The kernels at a microbatch's shapes (one row of llama3_600m_bench,
    # two of deepseek_mla_bench with V zero-padded) against their plain
    # versions, before any counted run.
    gen = torch.Generator(device="cuda").manual_seed(16)
    for case, (b, h, kh, d, pad_v) in {
            "pipeline_600m_microbatch": (RESUME_BATCH // PIPE_M, 12, 6, 128,
                                         0),
            "pipeline_mla_microbatch": (PIPE_MLA_BATCH // PIPE_M, 16, 16, 192,
                                        64)}.items():
        x = [torch.randn(b, RESUME_SEQ - 1, n, d, generator=gen,
                         device="cuda").to(torch.bfloat16)
             for n in (h, kh, kh, h)]
        if pad_v:
            x[2][..., d - pad_v:] = 0
        check_kernels(torch, flash, case, *x, {"causal": True})
        del x
    launches, bad = {}, []
    for name, (model, batch, schedules) in PIPE_CASES.items():
        t0 = time.perf_counter()
        cfg = resolve_model_preset(model)
        it = synthetic_batches(batch, RESUME_SEQ, cfg.vocab_size, seed=16)
        batches = [next(it) for _ in range(1 + PIPE_STEPS)]
        runs = {}
        for schedule, v in schedules:
            run = pipeline_run(torch, name, model, cfg, batch, schedule, v,
                               batches)
            runs[schedule] = run
            launches[f"{name}_{schedule}"] = run["launches"]
        want = runs["gpipe"]
        for schedule, run in runs.items():
            l0, g0 = run["losses"][0], run["grad_norms"][0]
            run["rel_diff_loss0_vs_gpipe"] = abs(l0 - want["losses"][0]) / \
                abs(want["losses"][0])
            run["rel_diff_grad_norm0_vs_gpipe"] = abs(
                g0 - want["grad_norms"][0]) / abs(want["grad_norms"][0])
            if schedule == "gpipe":
                run["rel_diff_loss0_vs_oracle"] = abs(
                    l0 - run["oracle_loss"]) / abs(run["oracle_loss"])
            emit(run | {"card_state": nvidia_smi(CARD_STATE)})
            if (not all(math.isfinite(x) for x in run["losses"])
                    or len(run["losses"]) != 1 + PIPE_STEPS
                    or run["rel_diff_loss0_vs_gpipe"] > PIPE_TOL
                    or run["rel_diff_grad_norm0_vs_gpipe"] > PIPE_TOL
                    or run.get("rel_diff_loss0_vs_oracle", 0.0) > PIPE_TOL
                    or run["launches"] != run["predicted_launches"]
                    or run["other_launches"]):
                bad.append(f"{name}_{schedule}")
        PHASE_SECONDS[name] = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"phase 16: {bad} failed their checks")
    return launches


# ---------------------------------------------------------- phase 17


def _mesh_diff(a, b) -> float:
    """The largest |a - b| / max(|b|, 1) over two lists of numbers:
    relative above 1, absolute below (GRPO's loss at a ratio of 1 is
    rounding noise around 0)."""
    return max((abs(x - y) / max(abs(y), 1.0) for x, y in zip(a, b)),
               default=0.0)


def _scaled_launches(launches: dict, steps: int, of: int) -> dict:
    """An earlier run's launches of ``of`` steps, scaled to ``steps``:
    what the same steps launch again."""
    return {k: v * steps // of for k, v in launches.items()}


def gang_grpo(torch, kind, smi, ref, launches) -> dict:
    """17a: 13c again sharded, MESH_GRPO_STEPS steps of ``run_rl`` on
    13c's prompts, group, lengths and seed (``grpo_run``'s checks: mean
    ratio within RATIO_TOL of 1, no flash launch in a decode, every d128
    kernel in each update). Held to 13c: every rollout's tokens equal,
    the losses, KL and grad norms within MESH_TOL (``_mesh_diff``), the
    launches by part 13c's per step. Returns the launches by part."""
    import numpy as np

    parts, got = grpo_run(torch, kind, smi, None, n_steps=MESH_GRPO_STEPS,
                          prompts=ref["prompts"])
    want = ref["history"][:MESH_GRPO_STEPS]
    diffs = {k: _mesh_diff([h[k] for h in got["history"]],
                           [h[k] for h in want])
             for k in ("loss", "kl", "grad_norm", "mean_ratio")}
    tokens_equal = len(got["tokens"]) == MESH_GRPO_STEPS and all(
        np.array_equal(a, b) for a, b in zip(got["tokens"], ref["tokens"]))
    predicted = {part: _scaled_launches(launches["grpo_" + part],
                                        MESH_GRPO_STEPS, GRPO_STEPS)
                 for part in parts}
    summary = {"sub_phase": "17a", "objective": "grpo",
               "model": "llama3_8b_lora (32 layers, rank 16)",
               "gang": got["gang"], "steps": MESH_GRPO_STEPS,
               "rows": GRPO_PROMPTS * GRPO_GROUP,
               "rollout_tokens_equal_13c": tokens_equal,
               "max_diff": diffs, "tol": MESH_TOL,
               "bit_equal": all(v == 0.0 for v in diffs.values()),
               "losses": [h["loss"] for h in got["history"]],
               "losses_13c": [h["loss"] for h in want],
               "kl": [h["kl"] for h in got["history"]],
               "kl_13c": [h["kl"] for h in want],
               "step_ms": [1e3 * (h["rollout_s"] + h["update_s"])
                           for h in got["history"]],
               "step_ms_13c": [1e3 * (h["rollout_s"] + h["update_s"])
                               for h in want],
               "peak_mem_gb": got["peak_mem_gb"],
               "peak_mem_gb_13c": ref["peak_mem_gb"],
               "launches": parts, "launches_predicted": predicted,
               "card_state": nvidia_smi(CARD_STATE), "device": kind,
               "nvidia_smi": smi}
    emit({"gang_post_summary": summary})
    if not (got["gang"] and tokens_equal
            and max(diffs.values()) <= MESH_TOL and parts == predicted):
        raise AssertionError(f"17a: {summary}")
    return parts


def gang_embed(torch, recipe, data, kind, smi, ref, launches) -> dict:
    """17b, one recipe: 13e's model and pairs again sharded for
    MESH_EMBED_STEPS steps (``embed_run``; in the gang ``embed`` refuses):
    losses, grad norms, accuracy, sim_pos and sim_neg within MESH_TOL of
    13e's, the d128 launches (non-causal for LLM2Vec) 13e's per step.
    Returns the launches."""
    got_launches, got = embed_run(torch, recipe, data, kind, smi,
                                  steps=MESH_EMBED_STEPS)
    want = ref["metrics"][:MESH_EMBED_STEPS]
    diffs = {k: _mesh_diff([m[k] for m in got["metrics"]],
                           [m[k] for m in want]) for k in want[0]}
    predicted = _scaled_launches(launches, MESH_EMBED_STEPS, EMBED_STEPS)
    summary = {"sub_phase": "17b", "objective": "embed_" + recipe,
               "model": EMBED_RECIPES[recipe][0], "gang": True,
               "causal": EMBED_RECIPES[recipe][1], "steps": MESH_EMBED_STEPS,
               "metrics": got["metrics"], "metrics_13e": want,
               "max_diff": diffs, "tol": MESH_TOL,
               "bit_equal": all(v == 0.0 for v in diffs.values()),
               "step_ms": [1e3 * m.step_time_s for m in got["history"]],
               "step_ms_13e": [1e3 * m.step_time_s
                               for m in ref["history"]][:MESH_EMBED_STEPS],
               "peak_mem_gb": got["peak_mem_gb"],
               "peak_mem_gb_13e": ref["peak_mem_gb"],
               "launches": got_launches, "launches_predicted": predicted,
               "card_state": nvidia_smi(CARD_STATE), "device": kind,
               "nvidia_smi": smi}
    emit({"gang_post_summary": summary})
    if max(diffs.values()) > MESH_TOL or got_launches != predicted:
        raise AssertionError(f"17b {recipe}: {summary}")
    return got_launches


def gang_vision(torch, chip, name, kind, smi, ref) -> None:
    """17c, one model: phase 12's run again sharded for MESH_VISION_STEPS
    steps of its schedule (``vision_run``, each rank its rows of the
    global batch): losses within MESH_TOL of phase 12's, and ResNet's
    BatchNorm running statistics after the last step within MESH_TOL of
    phase 12's after the same step."""
    got = vision_run(torch, name, vision_config(torch, name), chip, kind,
                     smi, steps=MESH_VISION_STEPS)
    want = ref["losses"][:MESH_VISION_STEPS]
    d_loss = _mesh_diff(got["losses"], want)
    d_bn = max((float((got["bn_stats"][k] - v).abs().max())
                / max(float(v.abs().max()), 1.0)
                for k, v in ref["bn_stats"].items()), default=0.0)
    summary = {"sub_phase": "17c", "objective": name, "gang": True,
               "steps": MESH_VISION_STEPS, "batch_size": VISION_BATCH,
               "losses": got["losses"], "losses_12": want,
               "max_diff_loss": d_loss, "bn_stats": len(ref["bn_stats"]),
               "max_diff_bn_stats": d_bn, "tol": MESH_TOL,
               "bit_equal": d_loss == 0.0 and d_bn == 0.0,
               "step_ms": [1e3 * m.step_time_s for m in got["history"]],
               "step_ms_12": [1e3 * m.step_time_s
                              for m in ref["history"]][:MESH_VISION_STEPS],
               "peak_mem_gb": got["peak_mem_gb"],
               "peak_mem_gb_12": ref["peak_mem_gb"],
               "card_state": nvidia_smi(CARD_STATE), "device": kind,
               "nvidia_smi": smi}
    emit({"gang_post_summary": summary})
    if (len(got["losses"]) != MESH_VISION_STEPS
            or max(d_loss, d_bn) > MESH_TOL
            or set(got["bn_stats"]) != set(ref["bn_stats"])):
        raise AssertionError(f"17c {name}: {summary}")


def gang_post_phase(torch, chip, kind, smi, vision_refs, post_refs,
                    post_launches) -> dict:
    """Phase 17: GRPO, contrastive embeddings and vision under the mesh,
    in a world-1 NCCL group on this card that the phase starts on a
    localhost ``TCPStore`` and destroys at its end (as phase 14): 17a
    GRPO, 17b each embedding recipe, 17c ViT-B/16 and ResNet-50, each
    held to its unwrapped run of phases 12 and 13 from the same seeds and
    batches, with its models freed before the next. Returns
    {run: {kernel: launches}} of the d128 kernels."""
    import torch.distributed as dist

    from tpufw_torch.cluster import init_process_group

    emit({"phase17_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    workdir = os.path.join(ROOT, "build-torch", f"phase17-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    out = {}

    def sub(name, fn):
        try:
            return _timed(name, fn)
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    init_process_group(f"127.0.0.1:{_free_port()}", 1, 0,
                       torch.device("cuda", 0))
    try:
        for part, counts in sub("17a", lambda: gang_grpo(
                torch, kind, smi, post_refs["grpo"], post_launches)).items():
            out["grpo_" + part] = counts
        data = post_train_data(workdir)
        for i, recipe in enumerate(EMBED_RECIPES):
            name = "embed_" + recipe
            out[name] = sub(f"17b{i + 1}", lambda r=recipe, n=name: gang_embed(
                torch, r, data, kind, smi, post_refs[n], post_launches[n]))
        for i, model in enumerate(VISION_MODELS):
            sub(f"17c{i + 1}", lambda m=model: gang_vision(
                torch, chip, m, kind, smi, vision_refs[m]))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase17_card_state_at_end": nvidia_smi(CARD_STATE)})
    return out


# ---------------------------------------------------------- phase 18

# Phase 18: each sub-phase trains its model twice from seed 0 on the same
# batches, unsplit and over one process's tensor (and expert) groups, the
# flash counters zeroed just before each run. Step losses and grad
# norms within TENSOR_TOL relative of the unsplit run's: the split sums
# the row-parallel partial products (o, down, the vocab-parallel
# embedding and head) shard by shard in bf16, which rounds differently.
# The gaps read 3e-7 to 4.2e-5 (losses) and 3e-6 to 1.7e-4 (grad norms)
# on an H100 at 700 W; a lost part of a row-parallel sum or a wrong KV
# head in a shard moves the grad norm by far more.
TENSOR_TOL = 1e-3
TENSOR_STEPS = 4
# name: (model, layers or None, (tensor, expert), batch, seq, steps).
TENSOR_CASES = {
    "18a": ("llama3_600m_bench", None, (2, 1), RESUME_BATCH, RESUME_SEQ,
            TENSOR_STEPS),
    "18b": ("deepseek_v2_lite_train_slice", V2LITE_TRAIN_LAYERS, (2, 2),
            2, 2048, TENSOR_STEPS),
    "18c": ("gemma2_9b_train_slice", GEMMA_TRAIN_LAYERS, (2, 1), 1, 8192,
            TENSOR_STEPS),
}


def tensor_config(name, n_layers):
    """(model config, trainer config kwargs) of a phase-18 case."""
    from tpufw_torch import configs

    if name == "llama3_600m_bench":
        return configs.resolve_model_preset(name), dict(loss_chunk_size=512)
    cfg, tcfg = getattr(configs, name)(n_layers)
    return cfg, dict(loss_chunk_size=tcfg.loss_chunk_size)


def tensor_run(torch, cfg, tkw, batches, groups, batch, seq,
               lora=False) -> dict:
    """One run of a phase-18 or 21 case: ``Trainer`` from seed 0 over
    ``groups`` (() unsplit; a ``LocalSequenceGroup`` among them is the
    ring its attention runs over) on ``batches``, the flash counters
    zeroed just before ``run`` and read just after. With ``lora``, its
    "only_adapters_moved" (``_only_adapters_moved``'s counts and "ok").
    Returns its summary."""
    from tpufw_torch.ops import flash
    from tpufw_torch.train import Trainer, TrainerConfig

    tcfg = TrainerConfig(batch_size=batch, seq_len=seq,
                         total_steps=len(batches), warmup_steps=2,
                         log_every=1, handle_preemption=False, **tkw)
    trainer = Trainer(cfg, tcfg, device="cuda", groups=groups)
    trainer.init_state(seed=0)
    before = _adapters_and_base(torch, trainer.model) if lora else None
    rec = _recorded(trainer, ("loss", "grad_norm"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    hist = trainer.run(iter(batches), model_flops_per_token=cfg.flops_per_token(
        seq - 1))
    torch.cuda.synchronize()
    launches = {k: c for k, c in flash.LAUNCHES.items() if c}
    moved = None
    if lora:
        try:
            moved = _only_adapters_moved(torch, trainer.model, before) | {
                "ok": True}
        except AssertionError as e:
            moved = {"ok": False, "error": str(e)}
        del before
    step_ms = [1e3 * m.step_time_s for m in hist[1:]]
    out = {"groups": {g.axis: g.size for g in groups},
           "losses": [float(r["loss"]) for r in rec],
           "grad_norms": [float(r["grad_norm"]) for r in rec],
           "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms) if step_ms else None,
           "tokens_per_sec": [m.tokens_per_sec_per_gpu for m in hist[1:]],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    if lora:
        out["only_adapters_moved"] = moved
    del trainer, rec, hist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tensor_phase(torch, kind, smi) -> dict:
    """Phase 18: tensor and expert shards on the card, in one process.
    Each TENSOR_CASES sub-phase trains unsplit, then split (18a
    llama3_600m_bench over LocalTensorGroup(2): flash d128 at 6/3 heads a
    shard; 18b the V2-Lite slice over LocalTensorGroup(2) x
    LocalExpertGroup(2): MLA at d192 with 8 heads and 32 routed experts a
    shard; 18c the Gemma-2-9B slice over LocalTensorGroup(2): d256 at 8/4
    heads a shard, soft caps, the tied vocab-parallel head of 256,000).
    Holds every loss finite, the split losses and grad norms within
    TENSOR_TOL of the unsplit ones, and the split run's launches of each
    kernel equal to the tensor size times the unsplit run's (each shard
    attends with its own heads), no other kernel launched. The kernels are first checked
    against their plain versions at a shard's shapes. Returns
    {sub-phase: the split run's launches}; raises AssertionError."""
    from tpufw_torch.ops import flash
    from tpufw_torch.parallel import LocalExpertGroup, LocalTensorGroup
    from tpufw_torch.train import synthetic_batches

    emit({"phase18_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    gen = torch.Generator(device="cuda").manual_seed(18)
    for case, (b, t, h, kh, d, pad_v, masks) in {
            "tensor_600m_shard": (RESUME_BATCH, RESUME_SEQ - 1, 6, 3, 128, 0,
                                  {"causal": True}),
            "tensor_v2lite_shard": (2, 2047, 8, 8, 192, 64, {"causal": True}),
            "tensor_gemma_shard": (1, GEMMA_T, 8, 4, 256, 0,
                                   {"causal": True,
                                    "soft_cap": GEMMA_ATTN_CAP})}.items():
        x = [torch.randn(b, t, n, d, generator=gen, device="cuda").to(
            torch.bfloat16) for n in (h, kh, kh, h)]
        if pad_v:
            x[2][..., d - pad_v:] = 0
        check_kernels(torch, flash, case, *x, masks)
        del x
        torch.cuda.empty_cache()
    launches, bad = {}, []
    for name, (model, layers, (tp, ep), batch, seq, steps) in \
            TENSOR_CASES.items():
        t0 = time.perf_counter()
        cfg, tkw = tensor_config(model, layers)
        it = synthetic_batches(batch, seq, cfg.vocab_size, seed=18)
        batches = [next(it) for _ in range(steps)]
        groups = tuple(g for g in (LocalTensorGroup(tp), LocalExpertGroup(ep))
                       if g.size > 1)
        whole = tensor_run(torch, cfg, tkw, batches, (), batch, seq)
        split = tensor_run(torch, cfg, tkw, batches, groups, batch, seq)
        d = head_dim_of(cfg)
        path = [flash.kernel_name(k, d) for k in flash.KERNELS]
        predicted = {k: tp * whole["launches"].get(k, 0) for k in path}
        rel, rel_gn = (
            [abs(a - b) / abs(b) for a, b in zip(split[k], whole[k])]
            for k in ("losses", "grad_norms"))
        out = {"tensor_summary": name, "model": model,
               "reduced": {"n_layers": [None, layers]} if layers else {},
               "n_layers": cfg.n_layers, "head_dim": d,
               "batch_size": batch, "seq_len": seq,
               "heads_per_shard": [cfg.n_heads // tp,
                                   getattr(cfg, "n_kv_heads", cfg.n_heads)
                                   // tp],
               "experts_per_shard": (getattr(cfg, "n_experts", 0) // ep
                                     if ep > 1 else None),
               "unsplit": whole, "split": split,
               "predicted_launches": predicted,
               "rel_diff_losses": rel, "rel_diff_grad_norms": rel_gn,
               "tol": TENSOR_TOL,
               "device": kind, "nvidia_smi": smi,
               "card_state": nvidia_smi(CARD_STATE)}
        emit(out)
        losses = whole["losses"] + split["losses"]
        if (len(split["losses"]) != steps
                or len(split["grad_norms"]) != steps
                or not all(math.isfinite(x) for x in losses)
                or max(rel + rel_gn) > TENSOR_TOL
                or not all(whole["launches"].get(k, 0) > 0 for k in path)
                or split["launches"] != {k: c for k, c in predicted.items()
                                         if c}):
            bad.append(name)
        launches[name] = {k: split["launches"].get(k, 0) for k in path}
        PHASE_SECONDS[name] = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"phase 18: {bad} failed their checks")
    return launches


# ---------------------------------------------------------- phase 19

# Phase 19: the post-trainers' heads over vocabulary shards (19a) and
# tensor and expert shards inside pipeline stages (19b-d) on one card, in
# one process: each case trains from seed 0 on the same batches twice,
# unsplit and split, held to each other within TENSOR_TOL (relative above
# 1, absolute below: GRPO's loss is rounding noise at a ratio of 1).
POST_TP_STEPS = 3
POST_TP_ROWS = 8
POST_TP_SEQ = 1024
# E5's rows a step and their length: InfoNCE at temperature 0.02 scales
# the bf16 rounding of the split's partial sums by 50 in the logits, and a
# loss over few pairs does not average it (the phase-19 probe, chip run 1,
# PR 21: 16 pairs of 512 moved the split's step-0 loss 2.9e-3 from the
# unsplit one's); 128 pairs of 128 tokens, the same 32k tokens a step, a
# batch of in-batch negatives nearer the recipe's. The unsplit run's own
# distance from its fp32 twin (plain attention) is printed beside it: the
# bf16 noise floor of the objective.
POST_TP_E5_ROWS = 256
POST_TP_E5_SEQ = 128
# DPO's learning rate, a full-parameter DPO's (Zephyr's 5e-7), and the
# steps gated: those before its first update (step 0's learning rate is
# the warm-up's 0). DPO's loss is the policy's margin over a fixed
# reference summed over 512 response tokens, and any update moves a
# share of the bf16 casts of the fp32 weights by an ulp, differently in
# two runs whose gradients differ in rounding: the probes (chip runs 1-2,
# PR 21) read step 2 6.8e-3 apart at lr 3e-4 and 1.7e-2 at 5e-7, the
# unsplit run 1.2e-3 from ln 2 against the split's 1.8e-2, with steps 0
# and 1 within 2.3e-5. Step 2 is printed beside the unsplit run's
# distance from its fp32 twin.
POST_TP_DPO_LR = 5e-7
POST_TP_DPO_GATED = 2
POST_TP_PROMPT_LENS = (64, 96)
POST_TP_GROUP = 4
POST_TP_NEW = 32
PIPE_TP_STEPS = 3
# Flash launches a layer of one step, (forward, dQ, dK/dV), unsplit, from
# the code (llama3_600m_bench remats its blocks, so a trained forward
# launches twice): DPO's reference forward (no grad) then the policy's
# forward and its recompute, one backward; distillation's teacher (the
# same 14 layers, no grad) likewise; E5's policy alone; GRPO's rollout
# scores once (no grad; the decode launches nothing) and its update runs
# the reference and the policy as DPO's step does. A split run launches
# each once a shard: the tensor size times these.
POST_TP_PER_LAYER = {"dpo": (3, 1, 1), "distill": (3, 1, 1),
                     "e5": (2, 1, 1), "grpo": (4, 1, 1)}
# Sub-phases 19b-d: name, (model, layers or None, batch, microbatches,
# [schedules], (tensor, expert)).
PIPE_TP_CASES = {
    "19b": ("llama3_600m_bench", None, RESUME_BATCH, PIPE_M,
            ["gpipe", "1f1b"], (2, 1)),
    "19c": ("deepseek_mla_bench", None, PIPE_MLA_BATCH, PIPE_M, ["gpipe"],
            (2, 1)),
    "19d": ("deepseek_v2_lite_train_slice", 2, 2, 2, ["gpipe"], (2, 2)),
}


def post_tp_batches(cfg, name) -> list:
    """POST_TP_STEPS batches of a 19a objective, drawn with numpy from
    seed 19: DPO pairs (the second half of each row the response), LM
    rows (distillation), or query/document pairs of a quarter of
    POST_TP_E5_SEQ to all of it, right-padded (E5, POST_TP_E5_ROWS
    rows)."""
    import numpy as np

    rng = np.random.default_rng(19)
    rows, seq = ((POST_TP_E5_ROWS, POST_TP_E5_SEQ) if name == "e5"
                 else (POST_TP_ROWS, POST_TP_SEQ))
    out = []
    for _ in range(POST_TP_STEPS):
        toks = rng.integers(1, cfg.vocab_size, (rows, seq))
        seg = np.ones_like(toks)
        if name == "e5":
            lens = rng.integers(seq // 4, seq + 1, rows)
            seg = (np.arange(seq) < lens[:, None]).astype(np.int32)
            out.append({"tokens": (toks * seg).astype(np.int32),
                        "segment_ids": seg.astype(np.int32)})
            continue
        b = {"tokens": toks.astype(np.int32), "segment_ids":
             seg.astype(np.int32)}
        if name == "dpo":
            b["loss_mask"] = np.broadcast_to(
                np.arange(seq) >= seq // 2, toks.shape).astype(
                    np.float32).copy()
        out.append(b)
    return out


def post_tp_run(torch, name, cfg, groups) -> dict:
    """One 19a run: the ``name`` trainer of ``llama3_600m_bench``
    (full-parameter) from seed 0 over ``groups`` (() unsplit), the flash
    counters zeroed just before it. DPO's reference and distillation's
    teacher (``llama3_600m_bench`` from seed 1, bf16) are cut by the same
    groups; GRPO rolls out POST_TP_PROMPT_LENS prompts x POST_TP_GROUP
    once, POST_TP_NEW tokens each, then updates once. Returns its
    summary."""
    import numpy as np

    from tpufw_torch.models import model_for_config
    from tpufw_torch.ops import flash
    from tpufw_torch.train import (
        ContrastiveConfig,
        DistillTrainer,
        DPOConfig,
        DPOTrainer,
        EmbeddingTrainer,
        GRPOConfig,
        GRPOTrainer,
        TrainerConfig,
    )
    from tpufw_torch.workloads.rl import resolve_reward

    kw = dict(batch_size=POST_TP_ROWS, seq_len=POST_TP_SEQ,
              total_steps=POST_TP_STEPS, warmup_steps=1, log_every=1,
              loss_chunk_size=512, handle_preemption=False)
    if name == "dpo":
        trainer = DPOTrainer(cfg, TrainerConfig(**dict(kw,
                                                       lr=POST_TP_DPO_LR)),
                             device="cuda",
                             dpo=DPOConfig(ref_dtype="float32"),
                             groups=groups)
    elif name == "distill":
        trainer = DistillTrainer(cfg, TrainerConfig(**kw), device="cuda",
                                 groups=groups)
    elif name == "e5":
        trainer = EmbeddingTrainer(
            cfg, TrainerConfig(**dict(kw, lr=2e-5, batch_size=POST_TP_E5_ROWS,
                                      seq_len=POST_TP_E5_SEQ)),
            device="cuda",
            contrastive=ContrastiveConfig(pooling="last", temperature=0.02),
            groups=groups)
    else:
        seq = max(POST_TP_PROMPT_LENS) + POST_TP_NEW
        trainer = GRPOTrainer(
            cfg, TrainerConfig(**dict(kw, seq_len=seq, total_steps=1,
                                      warmup_steps=0, lr=1e-5)),
            device="cuda", grpo=GRPOConfig(
                group_size=POST_TP_GROUP, max_new_tokens=POST_TP_NEW,
                kl_beta=0.02), groups=groups)
    trainer.init_state(seed=0)
    if name == "distill":
        trainer.set_teacher(model_for_config(cfg, device="cuda", seed=1))
    rec = _recorded(trainer, ("loss", "grad_norm") + (
        ("mean_ratio",) if name == "grpo" else ()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    if name == "grpo":
        import tpufw_torch.infer

        rng = np.random.default_rng(19)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in POST_TP_PROMPT_LENS]
        tokens, generate = [], tpufw_torch.infer.generate

        def recorded(*a, **k):
            out = generate(*a, **k)
            tokens.append(out.cpu())
            return out

        tpufw_torch.infer.generate = recorded
        try:
            hist = trainer.run_rl(prompts, resolve_reward(
                "low_token", cfg.vocab_size, POST_TP_NEW), seed=0)
        finally:
            tpufw_torch.infer.generate = generate
        step_ms = [1e3 * (h["rollout_s"] + h["update_s"]) for h in hist]
    else:
        batches = post_tp_batches(cfg, name)
        hist = trainer.run(iter(batches), model_flops_per_token=(
            cfg.flops_per_token(trainer.cfg.seq_len - 1)))
        step_ms = [1e3 * m.step_time_s for m in hist[1:]]
        tokens = None
    torch.cuda.synchronize()
    metrics = _floats(rec)
    out = {"groups": {g.axis: g.size for g in groups},
           "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms) if step_ms else None,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: c for k, c in flash.LAUNCHES.items() if c}}
    if name == "grpo":
        out["mean_ratio"] = [m["mean_ratio"] for m in metrics]
        out["tokens"] = [t.tolist() for t in tokens]
    del trainer, rec, hist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_tp_run(torch, name, model, cfg, batch, micro, schedule, tp, ep,
                batches) -> dict:
    """One 19b-d run: ``PipelineTrainer`` over a ``LocalPipeGroup(2)`` and
    ``MeshConfig(tensor=tp, expert=ep)``'s local groups from seed 0 on
    ``batches``, the flash counters zeroed just before. Returns its
    summary."""
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.ops import flash
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer, TrainerConfig

    seq = len(batches[0]["tokens"][0])
    tcfg = TrainerConfig(batch_size=batch, seq_len=seq,
                         total_steps=len(batches), warmup_steps=2,
                         log_every=1, loss_chunk_size=512,
                         handle_preemption=False)
    trainer = PipelineTrainer(cfg, PipelineConfig(2, micro, schedule), tcfg,
                              MeshConfig(pipe=2, fsdp=1, tensor=tp,
                                         expert=ep), device="cuda")
    trainer.init_state(seed=0)
    rec = _recorded(trainer, ("loss", "grad_norm"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    hist = trainer.run(iter(batches),
                       model_flops_per_token=cfg.flops_per_token(seq - 1))
    torch.cuda.synchronize()
    metrics = _floats(rec)
    step_ms = [1e3 * m.step_time_s for m in hist[1:]]
    out = {"groups": {g.axis: g.size for g in trainer.groups},
           "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms) if step_ms else None,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: c for k, c in flash.LAUNCHES.items() if c}}
    del trainer, rec, hist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _split_summary(flash, tag, d, whole, split, tp, predicted,
                   extra, gated=None) -> tuple[dict, bool]:
    """The summary line of one case (its unsplit and split runs) and
    whether it passed: every loss finite, the split losses and grad norms
    of the first ``gated`` steps (default all) within TENSOR_TOL of the
    unsplit ones, each run's launches of each kernel at head dim ``d``
    its prediction (the split run's the tensor size times
    ``predicted``), no other kernel launched."""
    path = [flash.kernel_name(k, d) for k in flash.KERNELS]
    want = {k: n for k, n in zip(path, predicted)}
    want_split = {k: tp * n for k, n in want.items()}
    d_loss, d_norm = (_mesh_diff(split[k][:gated], whole[k][:gated])
                      for k in ("losses", "grad_norms"))
    out = {"tensor_summary": tag, **extra, "head_dim": d,
           "unsplit": whole, "split": split,
           "predicted_launches": {"unsplit": want, "split": want_split},
           "gated_steps": gated or len(whole["losses"]),
           "max_diff_losses": d_loss, "max_diff_grad_norms": d_norm,
           "max_diff_losses_every_step": _mesh_diff(split["losses"],
                                                    whole["losses"]),
           "max_diff_grad_norms_every_step": _mesh_diff(
               split["grad_norms"], whole["grad_norms"]),
           "tol": TENSOR_TOL, "card_state": nvidia_smi(CARD_STATE)}
    good = (all(math.isfinite(x) for x in whole["losses"] + split["losses"])
            and len(split["losses"]) == len(whole["losses"]) > 0
            and max(d_loss, d_norm) <= TENSOR_TOL
            and whole["launches"] == {k: n for k, n in want.items() if n}
            and split["launches"] == {k: n for k, n in want_split.items()
                                      if n})
    return out, good


def tensor_pipe_phase(torch, kind, smi) -> dict:
    """Phase 19: 19a the post-trainers of ``llama3_600m_bench``
    (full-parameter) over ``LocalTensorGroup(2)``: DPO, distillation
    (a ``llama3_600m_bench`` teacher from seed 1), E5 (causal, last
    token) for POST_TP_STEPS steps each and GRPO (one rollout, one
    update), flash d128 at 6/3 heads a shard; 19b ``llama3_600m_bench``
    through GPipe and 1F1B over ``LocalPipeGroup(2)`` x
    ``LocalTensorGroup(2)`` at phase 16a's batch; 19c
    ``deepseek_mla_bench`` through GPipe over pipe 2 x tensor 2 (d192, 8
    heads a shard); 19d the V2-Lite slice (2 layers, uniform MoE stages)
    through GPipe over pipe 2 x tensor 2 x expert 2 (32 routed experts a
    stage's shard). Each against its unsplit run (``_split_summary``);
    DPO's step 0 at ln 2 and GRPO's ratio 1.0 on both runs, GRPO's
    rollout tokens equal (the decode runs on the whole policy). The
    kernels are first checked against their plain versions at the new
    shard shapes. Returns {case: the split run's launches by kernel};
    raises AssertionError."""
    from tpufw_torch import configs
    from tpufw_torch.ops import flash
    from tpufw_torch.parallel import LocalTensorGroup
    from tpufw_torch.train import synthetic_batches

    emit({"phase19_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    gen = torch.Generator(device="cuda").manual_seed(19)
    for case, (b, t, h, kh, d, pad_v) in {
            "tensor_post_600m_shard": (POST_TP_ROWS, POST_TP_SEQ - 1, 6, 3,
                                       128, 0),
            "tensor_pipeline_600m_shard": (RESUME_BATCH // PIPE_M,
                                           RESUME_SEQ - 1, 6, 3, 128, 0),
            "tensor_pipeline_mla_shard": (PIPE_MLA_BATCH // PIPE_M,
                                          RESUME_SEQ - 1, 8, 8, 192,
                                          64)}.items():
        x = [torch.randn(b, t, n, d, generator=gen, device="cuda").to(
            torch.bfloat16) for n in (h, kh, kh, h)]
        if pad_v:
            x[2][..., d - pad_v:] = 0
        check_kernels(torch, flash, case, *x, {"causal": True})
        del x
        torch.cuda.empty_cache()
    launches, bad = {}, []
    t0 = time.perf_counter()
    cfg = configs.bench_model_config()
    for name, (f, q, kv) in POST_TP_PER_LAYER.items():
        whole = post_tp_run(torch, name, cfg, ())
        split = post_tp_run(torch, name, cfg, (LocalTensorGroup(2),))
        steps = 1 if name == "grpo" else POST_TP_STEPS
        out, good = _split_summary(
            flash, f"19a_{name}", 128, whole, split, 2,
            [n * steps * cfg.n_layers for n in (f, q, kv)],
            {"model": "llama3_600m_bench", "objective": name,
             "rows": POST_TP_E5_ROWS if name == "e5" else POST_TP_ROWS,
             "seq_len": {"e5": POST_TP_E5_SEQ,
                         "grpo": max(POST_TP_PROMPT_LENS) + POST_TP_NEW}.get(
                             name, POST_TP_SEQ),
             "heads_per_shard": [cfg.n_heads // 2, cfg.n_kv_heads // 2],
             "device": kind, "nvidia_smi": smi},
            gated=POST_TP_DPO_GATED if name == "dpo" else None)
        if name == "dpo":
            good &= all(abs(r["losses"][0] - math.log(2.0))
                        <= DPO_ANCHOR_TOL for r in (whole, split))
        if name == "grpo":
            good &= all(abs(x - 1.0) <= RATIO_TOL for r in (whole, split)
                        for x in r["mean_ratio"])
            good &= whole.pop("tokens") == split.pop("tokens")
        if name in ("dpo", "e5"):
            # The objective's bf16 noise floor: the unsplit run against its
            # fp32 twin (plain attention), printed beside the split's gap.
            twin = post_tp_run(torch, name, dataclasses.replace(
                cfg, dtype=torch.float32, attention_backend="xla"), ())
            out["unsplit_vs_fp32_twin"] = {
                "max_diff_losses": _mesh_diff(whole["losses"],
                                              twin["losses"]),
                "max_diff_grad_norms": _mesh_diff(whole["grad_norms"],
                                                  twin["grad_norms"]),
                "fp32_twin": twin}
        emit(out)
        if not good:
            bad.append(f"19a_{name}")
        launches[f"19a_{name}"] = split["launches"]
    PHASE_SECONDS["19a"] = time.perf_counter() - t0
    for sub, (model, layers, batch, micro, schedules, (tp, ep)) in \
            PIPE_TP_CASES.items():
        t0 = time.perf_counter()
        if layers is None:
            cfg = configs.resolve_model_preset(model)
            seq, reduced = RESUME_SEQ, {}
        else:
            # Uniform MoE stages: the pipeline runs no dense first layer.
            cfg = dataclasses.replace(getattr(configs, model)(layers)[0],
                                      first_k_dense=0)
            seq = 2048
            reduced = {"n_layers": [27, layers], "first_k_dense": [1, 0]}
        it = synthetic_batches(batch, seq, cfg.vocab_size, seed=19)
        batches = [next(it) for _ in range(PIPE_TP_STEPS)]
        d = head_dim_of(cfg)
        for schedule in schedules:
            whole = pipe_tp_run(torch, sub, model, cfg, batch, micro,
                                schedule, 1, 1, batches)
            split = pipe_tp_run(torch, sub, model, cfg, batch, micro,
                                schedule, tp, ep, batches)
            per = PIPE_PER_LAYER[schedule]
            out, good = _split_summary(
                flash, f"{sub}_{schedule}", d, whole, split, tp,
                [n * PIPE_TP_STEPS * cfg.n_layers * micro for n in per],
                {"model": model, "reduced": reduced, "schedule": schedule,
                 "stages": 2, "microbatches": micro, "batch_size": batch,
                 "seq_len": seq, "n_layers": cfg.n_layers,
                 "heads_per_shard": cfg.n_heads // tp,
                 "experts_per_shard": (cfg.n_experts // ep if ep > 1
                                       else None),
                 "device": kind, "nvidia_smi": smi})
            emit(out)
            if not good:
                bad.append(f"{sub}_{schedule}")
            launches[f"{sub}_{schedule}"] = split["launches"]
        PHASE_SECONDS[sub] = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"phase 19: {bad} failed their checks")
    return launches



# ---------------------------------------------------------- phase 20

# Phase 20: the telemetry layer on the card. 20a: train_llama's
# build_trainer at phase 7b's shapes (llama3_600m_bench, B=4 x 2048,
# remat `dots`) for TEL_STEPS steps with TPUFW_TELEMETRY_DIR,
# TPUFW_PROFILE_DIR, TPUFW_METRICS_PORT=0 and TPUFW_PROFILE_STEPS set;
# 20b: the same run with telemetry off, TEL_RUNS of each at once;
# 20c: phase 6's server model (Llama-3-8B widths at ONLINE_LAYERS layers)
# behind a server with TPUFW_TELEMETRY_DIR and a /debug/profile capture.
# 12 steps, not 8: the median of the 9 steps neither counted nor profiled
# holds the on/off ratio steadier than 5 would (a run's own steps spread
# 185-283 ms at these shapes on an H100 80GB HBM3 at 700 W).
TEL_STEPS = 12
TEL_PROFILE = (4, 6)
# The median step of the telemetry-on runs over that of the telemetry-off
# runs, each pooled over its runs' steps that are neither counted (index
# 0) nor profiled.
TEL_OVERHEAD_TOL = 1.10
# Runs a side in turns, after 20a's run alone (the first "off" run is
# 20b). The step is host-bound and the host's speed drifts within
# seconds: runs one after another in one process, on/off/off/on thrice,
# read a pooled ratio of 0.945-1.106 on H100 80GB HBM3 cards at 700 W
# (chip_smoke.py), while two trainers stepped in turn agreed to
# 0.991-1.053 over 23 steps each (scripts/telemetry_overhead_torch.py
# --pairs). So the on and the off runs go at once, each side in a
# process of its own, and take turns step by step (telemetry_worker):
# both steps of a turn pair see one host. 20a runs alone, as a user runs
# it: its spans and goodput would count the turns as idle.
TEL_RUNS = 6
# Seconds a side waits for its turn, or the phase for a side's result.
TEL_TURN_S = 600
TEL_MEDIAN_STEPS = [i for i in range(1, TEL_STEPS)
                    if not TEL_PROFILE[0] <= i < TEL_PROFILE[1]]
# The counted step's FLOPs over the model FLOPs of one step
# (LlamaConfig.flops_per_token x tokens): above 1 by dQ's and dK/dV's
# recomputed scores, `dots`'s second flash forward and the chunked CE's
# second head forward (1.0907 from the code at these shapes).
TEL_FLOP_BAND = (1.0, 4.0 / 3.0)
# Flash launches (forward, dQ, dK/dV) of one llama3_600m_bench step under
# `dots`: each of the 14 layers' forward and its recompute, one backward.
TEL_STEP_LAUNCHES = {"flash_fwd": 28, "flash_dq": 14, "flash_dkv": 14}
TEL_SERVE_NEW = 48
TEL_SERVE_PROMPTS = 4


def trace_kernels(path: str) -> list:
    """(name, start us, duration us) of every device operation (kernel,
    memcpy, memset) of a ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")]


def trace_window_us(path: str, ops) -> float:
    """Microseconds from the first ``train_step#<i>`` record of a
    StepProfiler trace to its last device operation's end: the profiled
    steps' time, without the profiler's start, stop and export."""
    with open(path) as f:
        marks = [e["ts"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("train_step#")]
    if not (marks and ops):
        return 0.0
    return max(ts + dur for _, ts, dur in ops) - min(marks)


def busy_us(ops) -> float:
    """The union of the operations' intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted((ts, ts + dur) for _, ts, dur in ops):
        total += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return total


def flash_trace_counts(ops) -> dict:
    """Launches of each head-dim-128 flash kernel in a trace, by its
    symbol (``HOPPER_KERNELS``)."""
    return {base: sum(1 for name, _, _ in ops
                      if HOPPER_KERNELS[base][1] in name)
            for base in ("flash_fwd", "flash_dq", "flash_dkv")}


def span_coverage(spans) -> float:
    """The share of the step loop (the first step_dispatch's start to the
    last host_sync's end) the spans cover, their union."""
    t0 = min(s["ts"] for s in spans if s["name"] == "step_dispatch")
    t1 = max(s["ts"] + s["dur"] for s in spans if s["name"] == "host_sync")
    ops = [("", max(s["ts"], t0), min(s["ts"] + s["dur"], t1)
            - max(s["ts"], t0)) for s in spans
           if s["ts"] + s["dur"] > t0 and s["ts"] < t1]
    return busy_us(ops) / (t1 - t0)


def telemetry_train(torch, workdir: str, on: bool, handoff=None) -> dict:
    """One run of 20a (``on``) or 20b through train_llama's
    ``build_trainer`` and ``Trainer.run`` on TEL_STEPS synthetic batches
    already on the card; the launch counts zeroed just before, read just
    after, and per step from ``on_metrics``, which then calls
    ``handoff()`` where given (the turn of phase 20's other run). Returns
    the history, the launches and, with telemetry, the scrape taken
    during the run."""
    import urllib.request

    from tpufw_torch.ops import flash
    from tpufw_torch.train import synthetic_batches
    from tpufw_torch.workloads import train_llama

    for k in [k for k in os.environ if k.startswith("TPUFW_")]:
        del os.environ[k]
    env = {"TPUFW_MODEL": "llama3_600m_bench",
           "TPUFW_BATCH_SIZE": str(RESUME_BATCH),
           "TPUFW_SEQ_LEN": str(RESUME_SEQ),
           "TPUFW_TOTAL_STEPS": str(TEL_STEPS), "TPUFW_LOG_EVERY": "1",
           "TPUFW_LOSS_CHUNK_SIZE": "512"}
    if on:
        env |= {"TPUFW_TELEMETRY_DIR": os.path.join(workdir, "telemetry"),
                "TPUFW_PROFILE_DIR": os.path.join(workdir, "profile"),
                "TPUFW_METRICS_PORT": "0",
                "TPUFW_PROFILE_STEPS": "%d:%d" % TEL_PROFILE}
    os.environ.update(env)
    try:
        trainer, cfg = train_llama.build_trainer()
        trainer.init_state(seed=0)
        it = synthetic_batches(RESUME_BATCH, RESUME_SEQ, cfg.vocab_size,
                               seed=7)
        batches = [{k: torch.from_numpy(v).cuda() for k, v in
                    next(it).items()} for _ in range(TEL_STEPS)]
        scraped, per_step = {}, []

        def on_metrics(m):
            per_step.append(dict(flash.LAUNCHES))
            if on and m.step >= 2 and "text" not in scraped:
                url = f"http://127.0.0.1:{trainer.telemetry.bound_port}/metrics"
                with urllib.request.urlopen(url, timeout=60) as r:
                    scraped["text"] = r.read().decode()
            if handoff is not None:
                handoff()

        torch.cuda.synchronize()
        flash.reset_launch_counts()
        history = trainer.run(iter(batches),
                              model_flops_per_token=cfg.flops_per_token(
                                  RESUME_SEQ - 1),
                              on_metrics=on_metrics)
        torch.cuda.synchronize()
        launches = {k: flash.LAUNCHES[k] for k in flash.KERNELS}
    finally:
        for k in env:
            os.environ.pop(k, None)
    del trainer, batches
    return {"history": history, "launches": launches, "per_step": per_step,
            "scrape": scraped.get("text", ""), "cfg": cfg}


def telemetry_checks(run: dict, workdir: str) -> dict:
    """20a's gates on the files of the telemetry-on run: the live scrape,
    the events' schema, the goodput rollup, the spans' coverage, the
    programs.json entry and its FLOP ratio, and the profiler trace's
    flash kernels against the launch counts of the profiled steps."""
    from tpufw_torch.obs import events as events_mod
    from tpufw_torch.obs.perf import load_programs
    from tpufw_torch.ops import flash

    tel = os.path.join(workdir, "telemetry")
    bad = []
    text = run["scrape"]
    for series in ("tpufw_train_steps_total ", "tpufw_train_mfu ",
                   "tpufw_train_data_wait_seconds_bucket"):
        if series not in text:
            bad.append(f"scrape lacks {series.strip()}")
    events = events_mod.read_events(os.path.join(tel, "events.jsonl"))
    for ev in events:
        events_mod.validate(ev)
    kinds = [e["kind"] for e in events]
    if kinds[:1] != ["run_start"] or "run_end" not in kinds:
        bad.append(f"events {kinds}")
    with open(os.path.join(tel, "goodput.json")) as f:
        gp = json.load(f)
    gp_sum = sum(gp["categories"].values())
    if abs(gp_sum - gp["wall_s"]) > 0.02 * gp["wall_s"]:
        bad.append("goodput categories do not sum to the wall")
    with open(os.path.join(tel, "trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    coverage = span_coverage(spans)
    if coverage < 0.95:
        bad.append(f"spans cover {coverage:.3f} of the step loop")
    prog = load_programs(tel)["programs"]["train_step"]
    cfg = run["cfg"]
    tokens = RESUME_BATCH * (RESUME_SEQ - 1)
    model_flops = cfg.flops_per_token(RESUME_SEQ - 1) * tokens
    ratio = prog["flops"] / model_flops
    if not TEL_FLOP_BAND[0] <= ratio <= TEL_FLOP_BAND[1]:
        bad.append(f"counted FLOPs {ratio:.4f} x the model's")
    for key in ("flops", "bytes_accessed", "ai_flops_per_byte", "bound",
                "peak_hbm_bytes"):
        if not prog.get(key):
            bad.append(f"programs.json train_step lacks {key}")
    # The flash share: each launch of the counted step at its shapes.
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want_flash = {
        k: {"launches": n, **dict(zip(("flops", "bytes"), (
            n * c for c in flash.flash_costs(k, RESUME_BATCH, RESUME_SEQ - 1,
                                             RESUME_SEQ - 1, h, kh, d))))}
        for k, n in TEL_STEP_LAUNCHES.items()}
    if prog["flash"] != want_flash:
        bad.append(f"flash costs {prog['flash']} != {want_flash}")
    # The profiled steps' kernels by name, against the launch counts of
    # those steps (on_metrics snapshots after each step).
    a, b = TEL_PROFILE
    per = run["per_step"]
    window = {k: per[b - 1][k] - per[a - 1][k] for k in flash.KERNELS}
    traces = sorted(glob.glob(os.path.join(workdir, "profile", "*.json")))
    ops = trace_kernels(traces[0]) if traces else []
    in_trace = flash_trace_counts(ops)
    want_window = {k: n * (b - a) for k, n in TEL_STEP_LAUNCHES.items()}
    if not (in_trace == window == want_window):
        bad.append(f"profiled flash kernels {in_trace}, launches {window}, "
                   f"predicted {want_window}")
    window_us = trace_window_us(traces[0], ops) if traces else 0.0
    busy = busy_us(ops)
    flash_us = sum(dur for name, _, dur in ops if any(
        HOPPER_KERNELS[k][1] in name for k in flash.KERNELS))
    out = {"check": "telemetry_train", "events": len(events),
           "event_kinds": sorted(set(kinds)), "goodput": gp,
           "goodput_categories_sum_s": gp_sum, "span_coverage": coverage,
           "program": {k: prog.get(k) for k in (
               "flops", "aten_flops", "flash_flops", "bytes_accessed",
               "aten_bytes", "flash_bytes", "ai_flops_per_byte", "bound",
               "peak_hbm_bytes", "argument_bytes", "temp_bytes",
               "reserved_bytes", "mfu", "calls", "wall_s", "error")},
           "flash_costs": prog["flash"],
           "model_flops_per_step": model_flops,
           "counted_over_model_flops": ratio, "flop_band": TEL_FLOP_BAND,
           "profiled_flash_kernels": in_trace,
           "profiled_window_launches": window,
           "predicted_window_launches": want_window,
           "trace_ops": len(ops), "trace_busy_ms_per_step":
               busy / 1e3 / (b - a),
           "trace_window_ms_per_step": window_us / 1e3 / (b - a),
           "trace_idle_share": 1.0 - busy / window_us if window_us else None,
           "meter_ms_profiled_steps": [1e3 * m.step_time_s
                                       for m in run["history"][a:b]],
           "trace_flash_share_of_busy": flash_us / busy if busy else None,
           "launches_run": run["launches"], "ok": not bad}
    emit(out)
    if bad:
        raise AssertionError(f"20a: {bad}")
    return out


def telemetry_serve(workdir: str, kind, smi) -> dict:
    """20c: phase 6's model (contiguous pool) behind a server with
    TPUFW_TELEMETRY_DIR; a /debug/profile capture of 1 s started with
    TEL_SERVE_PROMPTS concurrent streams in flight. Holds the capture's
    CUDA activity to decode kernels and no flash kernel, no flash
    launch, the serve trace, goodput tables and decode programs."""
    import numpy as np

    from tpufw_torch.configs import llama3_8b_serve_slice
    from tpufw_torch.models import Llama
    from tpufw_torch.obs.perf import load_programs
    from tpufw_torch.ops import flash
    from tpufw_torch.workloads import serve

    cfg = dataclasses.replace(llama3_8b_serve_slice()[0],
                              n_layers=ONLINE_LAYERS)
    model = Llama(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (64, 200, 511, 7)[:TEL_SERVE_PROMPTS]]
    tel = os.path.join(workdir, "serve")
    flash.reset_launch_counts()
    srv, base = _start_server(serve, {"TPUFW_TELEMETRY_DIR": tel},
                              model=model)
    try:
        with _get(base + "/debug/profile?seconds=1") as r:
            capture = json.loads(r.read())
        runs = _concurrently([
            (lambda p=p: _stream(base, {"prompts": [p],
                                        "max_new_tokens": TEL_SERVE_NEW}))
            for p in prompts])
        trace = os.path.join(capture["dir"], "trace.json")
        deadline = time.time() + 120
        while not os.path.exists(trace) and time.time() < deadline:
            time.sleep(0.1)
        metrics = _metrics(base)
    finally:
        srv.shutdown()
        for k in [k for k in os.environ if k.startswith("TPUFW_")]:
            del os.environ[k]
    launches = {k: flash.LAUNCHES[k] for k in flash.LAUNCHES}
    ops = trace_kernels(trace) if os.path.exists(trace) else []
    kernels = [name for name, _, _ in ops]
    flash_in_trace = sum(flash_trace_counts(ops).values()) + sum(
        1 for n in kernels if "flash_" in n)
    with open(os.path.join(tel, "goodput.json")) as f:
        gp = json.load(f)
    progs = (load_programs(tel) or {}).get("programs", {})
    decode = {k: {f: v.get(f) for f in ("flops", "bytes_accessed",
                                          "ai_flops_per_byte", "mfu",
                                          "calls")}
              for k, v in progs.items() if k.startswith("serve_decode_k")}
    bad = []
    if not (capture.get("started") and ops):
        bad.append(f"capture {capture} has no device operations")
    if flash_in_trace or any(launches.values()):
        bad.append(f"flash on the serve path: {flash_in_trace} in the "
                   f"trace, launches {launches}")
    if not all(len(r[0]) == TEL_SERVE_NEW for r in runs):
        bad.append("a stream did not finish")
    for name in ("trace-serve.json", "events.jsonl", "goodput.json",
                 "metrics.prom"):
        if not os.path.exists(os.path.join(tel, name)):
            bad.append(f"no {name}")
    if not ({"busy", "wasted_slot"} <= set(gp["categories"])
            and "tpufw_goodput_ratio" in metrics and decode):
        bad.append("no goodput tables or decode programs")
    top: dict = {}
    for name, _, dur in ops:
        top[name[:80]] = top.get(name[:80], 0.0) + dur
    out = {"check": "telemetry_serve", "capture": capture,
           "trace_ops": len(ops), "trace_busy_ms": busy_us(ops) / 1e3,
           "top_kernels_ms": sorted(((n, us / 1e3) for n, us in top.items()),
                                    key=lambda x: -x[1])[:8],
           "flash_in_trace": flash_in_trace, "flash_launches": launches,
           "goodput": gp, "decode_programs": decode,
           "tokens": [len(r[0]) for r in runs], "device": kind,
           "nvidia_smi": smi, "ok": not bad}
    emit(out)
    if bad:
        raise AssertionError(f"20c: {bad}")
    return out


def telemetry_worker(mode: str, dirs: list, batons: tuple, results,
                     solo: Optional[str] = None) -> None:
    """One side of phase 20's train runs (``mode`` "on" or "off"), in a
    process of its own: a run of ``telemetry_train`` into each of
    ``dirs``, holding the turn (``batons``: this side's semaphore, then
    the other's) from each step's sync to the other side's next. With
    ``solo`` ("on" for 20a) the first run is alone, in that mode: it
    keeps the turn throughout, so its spans and goodput see no turns, and
    20a's checks run on it when it is "on". Puts
    ``(mode, {"solo": row or None, "runs": rows}, checks)`` on
    ``results``, or ``(mode, None, error)``."""
    import traceback

    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mine, other = batons

    def turn() -> None:
        if not mine.acquire(timeout=TEL_TURN_S):
            raise AssertionError(f"20 ({mode}): no turn in {TEL_TURN_S} s")

    def handoff() -> None:
        other.release()
        turn()

    def row(run: dict) -> dict:
        return {"step_ms": [1e3 * m.step_time_s for m in run["history"]],
                "losses": [m.loss for m in run["history"]],
                "mfu": [m.mfu for m in run["history"]],
                "launches": run["launches"]}

    out, checks = {"solo": None, "runs": []}, None
    try:
        turn()
        if solo:
            run = telemetry_train(torch, dirs[0], on=solo == "on")
            if solo == "on":
                checks = telemetry_checks(run, dirs[0])
            out["solo"] = row(run)
            dirs = dirs[1:]
        for d in dirs:
            run = telemetry_train(torch, d, on=mode == "on", handoff=handoff)
            out["runs"].append(row(run))
            del run
            gc.collect()
            torch.cuda.empty_cache()
        results.put((mode, out, checks))
    except BaseException:  # noqa: BLE001 - the phase reports it
        results.put((mode, None, traceback.format_exc()))
    finally:
        other.release()


def telemetry_phase(torch, kind, smi) -> dict:
    """Phase 20: 20a's run with telemetry alone and its checks, then
    TEL_RUNS train runs with telemetry and as many without, the two sides
    at once in processes of their own taking turns step by step
    (``telemetry_worker``), the overhead gate on the pooled medians of
    the turns, then 20c. Returns the d128 launch counts of 20a and of the
    first run without telemetry."""
    import multiprocessing
    import queue

    from tpufw_torch.ops import flash

    workdir = os.path.join(ROOT, "build-torch", f"phase20-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    batons = {m: ctx.Semaphore(0) for m in ("on", "off")}
    results = ctx.Queue()
    dirs = {m: [os.path.join(workdir, f"{m}{j}") for j in range(TEL_RUNS)]
            for m in ("on", "off")}
    dirs["on"].insert(0, os.path.join(workdir, "20a"))
    for d in dirs["on"] + dirs["off"]:
        os.makedirs(d, exist_ok=True)
    procs = [ctx.Process(target=telemetry_worker, args=(
        m, dirs[m], (batons[m], batons["off" if m == "on" else "on"]),
        results, "on" if m == "on" else None), daemon=True)
        for m in ("on", "off")]
    try:
        for p in procs:
            p.start()
        # The "on" side (20a) takes the first turn.
        batons["on"].release()
        got, deadline = {}, time.monotonic() + TEL_TURN_S
        while len(got) < len(procs):
            try:
                m, out, info = results.get(timeout=5)
            except queue.Empty:
                # A side that died before its result ends the wait.
                dead = [m for m, p in zip(("on", "off"), procs)
                        if m not in got and not p.is_alive()]
                if dead and results.empty() or time.monotonic() > deadline:
                    raise AssertionError(
                        f"20: no result from {sorted({'on', 'off'} - set(got))}"
                        f" (exited: {dead})") from None
                continue
            if out is None:
                raise AssertionError(f"20 ({m}): {info}")
            got[m] = (out, info)
            deadline = time.monotonic() + TEL_TURN_S
        for p in procs:
            p.join(timeout=60)
        (ons, checks), (offs, _) = got["on"], got["off"]
        on, off = ons["solo"], offs["runs"][0]
        runs = [r for pair in zip(ons["runs"], offs["runs"]) for r in pair]
        order = ["on", "off"] * TEL_RUNS
        steps = {m: [r["step_ms"][i] for r in got[m][0]["runs"]
                     for i in TEL_MEDIAN_STEPS] for m in ("on", "off")}
        med = {m: statistics.median(v) for m, v in steps.items()}
        ratio = med["on"] / med["off"]
        counted_out = all(
            "tpufw_train_step_time_seconds_count %d" % (TEL_STEPS - 1)
            in open(os.path.join(d, "telemetry", "metrics.prom")).read()
            for d in dirs["on"])
        emit({"telemetry_summary": {
            "model": "llama3_600m_bench", "batch_size": RESUME_BATCH,
            "seq_len": RESUME_SEQ, "steps": TEL_STEPS,
            "profile_steps": TEL_PROFILE, "median_steps": TEL_MEDIAN_STEPS,
            "order": order, "turns": "step", "solo_20a_ms": on["step_ms"],
            "step_ms": [r["step_ms"] for r in runs],
            "run_median_ms": [statistics.median(
                r["step_ms"][i] for i in TEL_MEDIAN_STEPS) for r in runs],
            "median_ms_on": med["on"], "median_ms_off": med["off"],
            "on_over_off": ratio, "tol": TEL_OVERHEAD_TOL,
            "counted_step_ms": on["step_ms"][0],
            "counted_step_out_of_meter": counted_out,
            "losses_on": on["losses"], "losses_off": off["losses"],
            "losses_equal": all(r["losses"] == on["losses"] for r in runs),
            "counted_over_model_flops": checks["counted_over_model_flops"],
            "mfu_counted_program": checks["program"]["mfu"],
            "mfu_meter_median": statistics.median(
                on["mfu"][i] for i in TEL_MEDIAN_STEPS),
            # The profiled steps' device time over an unprofiled step.
            "trace_busy_over_median_off": checks["trace_busy_ms_per_step"]
            / med["off"],
            "device": kind, "nvidia_smi": smi,
            "card_state": nvidia_smi(CARD_STATE),
            "card_state_query": CARD_STATE}})
        if ratio > TEL_OVERHEAD_TOL or not counted_out:
            raise AssertionError(
                f"20b: telemetry on/off median {ratio:.3f} (tol "
                f"{TEL_OVERHEAD_TOL}), counted step out of the meter: "
                f"{counted_out}")
        want = {k: n * TEL_STEPS for k, n in TEL_STEP_LAUNCHES.items()}
        for j, (r, mode) in enumerate(zip([on, *runs], ["20a", *order])):
            if r["launches"] != want:
                raise AssertionError(
                    f"20 ({mode} run {j}): launches {r['launches']} != "
                    f"{want}")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        telemetry_serve(workdir, kind, smi)
        PHASE_SECONDS["20c"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        shutil.rmtree(workdir, ignore_errors=True)
    return {"20a": {flash.kernel_name(k, 128): n
                    for k, n in on["launches"].items()},
            "20b": {flash.kernel_name(k, 128): n
                    for k, n in off["launches"].items()}}


# ---------------------------------------------------------- phase 21

# Phase 21: the tensor and expert axes beside a sequence ring, under LoRA
# adapters and in the vision trainer, on one card in one process. Steps
# a run, the ring's shards, and 21a-b's rows of SEQTP_SEQ tokens: 2048
# trained positions, two ring chunks of 1024 (2047, phase 18's, do not
# split in two).
SEQTP_STEPS = 3
SEQTP_RING = 2
SEQTP_SEQ = RESUME_SEQ + 1
SEQTP_LORA_LAYERS = 4
SEQTP_VIT_BATCH = 64
# Sub-phases 21a-c: name, (model, layers or None, batch, seq, backends,
# (tensor, expert), ring shards).
SEQTP_CASES = {
    "21a": ("llama3_600m_bench", None, RESUME_BATCH, SEQTP_SEQ,
            ("ring", "ulysses"), (2, 1), SEQTP_RING),
    "21b": ("deepseek_v2_lite_train_slice", V2LITE_TRAIN_LAYERS, 2,
            SEQTP_SEQ, ("ring",), (1, 2), SEQTP_RING),
    "21c": ("llama3_8b_lora_train_slice", SEQTP_LORA_LAYERS, 2, 2048,
            ("flash",), (2, 1), 1),
}


def seqtp_launches(torch, cfg, backend, ring, steps) -> list:
    """The flash launches (forward, dQ, dK/dV) of ``steps`` unsplit
    steps of ``cfg`` on ``backend`` over a ring of ``ring`` shards held in
    one process, from the code: each layer's attention call launches, per
    kernel, one per live chunk of the causal ring (``_expected_chunks``:
    the diagonal chunks and those before them), one per head group of
    Ulysses (its shards), one for ``flash``; the forward once more under
    a remat policy that recomputes it ("dots", "nothing"). A split run
    launches each once a tensor shard."""
    if backend == "ring":
        per_call = sum(_expected_chunks(ring, 0, None)[k]
                       for k in ("fwd_full", "fwd_diag"))
    else:
        per_call = ring if backend == "ulysses" else 1
    passes = 2 if cfg.remat and cfg.remat_policy in ("dots", "nothing") \
        else 1
    calls = cfg.n_layers * steps * per_call
    return [passes * calls, calls, calls]


def seqtp_config(name, layers, backend):
    """(model config on ``backend``, trainer kwargs) of a 21a-c case."""
    from tpufw_torch import configs

    if layers is None:
        cfg, tkw = configs.resolve_model_preset(name), dict(
            loss_chunk_size=512)
    else:
        cfg, tcfg = getattr(configs, name)(layers)
        tkw = dict(loss_chunk_size=tcfg.loss_chunk_size)
    return dataclasses.replace(cfg, attention_backend=backend), tkw


def seqtp_vit(torch, kind, smi) -> tuple[dict, bool]:
    """21d: ViT-B/16 at SEQTP_VIT_BATCH images of 224 px, SEQTP_STEPS
    steps of ``VisionTrainer`` (one warm-up step) unsplit and at
    ``MeshConfig(tensor=2)`` from the same weights on the same images:
    (summary line, passed): finite losses within TENSOR_TOL, no flash
    launch (its attention is two matmuls). The weights are seed 0's with
    the class head drawn at std 0.02 instead of zeros: a zero head
    passes no gradient to the blocks, and the first steps' losses would
    not see the split blocks at all."""
    import itertools

    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.models import VIT_CONFIGS
    from tpufw_torch.ops import flash
    from tpufw_torch.train import (
        VisionTrainer,
        VisionTrainerConfig,
        synthetic_images,
    )
    from tpufw_torch.train.vision import vision_model

    cfg = VIT_CONFIGS["vit_b16"]
    state = vision_model(cfg, "cuda", seed=0).state_dict()
    state["head.weight"].normal_(0.0, 0.02, generator=torch.Generator(
        device="cuda").manual_seed(21))
    runs = {}
    for tag, mesh in (("unsplit", None), ("split", MeshConfig(tensor=2,
                                                              fsdp=1))):
        trainer = VisionTrainer(cfg, VisionTrainerConfig(
            batch_size=SEQTP_VIT_BATCH, image_size=224, num_classes=1000,
            total_steps=SEQTP_STEPS, lr=1e-3, warmup_steps=1,
            handle_preemption=False), mesh, device="cuda")
        trainer.init_state(state_dict=state)
        data = synthetic_images(SEQTP_VIT_BATCH, 224, 1000, seed=21,
                                device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launch_counts()
        hist = trainer.run(itertools.islice(data, SEQTP_STEPS),
                           flops_per_image=cfg.flops_per_image(224))
        torch.cuda.synchronize()
        step_ms = [1e3 * m.step_time_s for m in hist[1:]]
        runs[tag] = {"groups": {g.axis: g.size for g in trainer.groups},
                     "losses": [m.loss for m in hist], "step_ms": step_ms,
                     "median_step_ms": (statistics.median(step_ms)
                                        if step_ms else None),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {k: c for k, c in flash.LAUNCHES.items()
                                  if c}}
        del trainer, hist
        gc.collect()
        torch.cuda.empty_cache()
    del state
    whole, split = runs["unsplit"], runs["split"]
    d_loss = _mesh_diff(split["losses"], whole["losses"])
    out = {"seq_tensor_summary": "21d", "model": "vit_b16",
           "batch_size": SEQTP_VIT_BATCH, "image_size": 224,
           "heads_per_shard": cfg.n_heads // 2, "unsplit": whole,
           "split": split, "max_diff_losses": d_loss, "tol": TENSOR_TOL,
           "predicted_launches": {}, "device": kind, "nvidia_smi": smi,
           "card_state": nvidia_smi(CARD_STATE)}
    good = (len(split["losses"]) == len(whole["losses"]) == SEQTP_STEPS
            and all(math.isfinite(x) for x in whole["losses"]
                    + split["losses"])
            and d_loss <= TENSOR_TOL
            and not whole["launches"] and not split["launches"])
    return out, good


def seq_tensor_phase(torch, kind, smi) -> dict:
    """Phase 21: 21a ``llama3_600m_bench`` over ``LocalTensorGroup(2)``
    beside a ``LocalSequenceGroup(2)`` ring, ``ring`` then ``ulysses``;
    21b the V2-Lite slice over ``LocalExpertGroup(2)`` beside the ring;
    21c the Llama-3-8B LoRA slice's widths over ``LocalTensorGroup(2)``
    (only the adapters move); 21d ViT-B/16 at ``MeshConfig(tensor=2)``.
    Each against its unsplit run (``_split_summary``; the ring is held
    alike by both). The kernels are first checked against their plain
    versions at a shard's ring-chunk and Ulysses shapes. Returns {case:
    the split run's launches by kernel}; raises AssertionError."""
    from tpufw_torch.ops import flash
    from tpufw_torch.parallel import (
        LocalExpertGroup,
        LocalSequenceGroup,
        LocalTensorGroup,
    )
    from tpufw_torch.train import synthetic_batches

    emit({"phase21_allocated_at_start_gb":
          torch.cuda.memory_allocated() / 1e9,
          "card_state": nvidia_smi(CARD_STATE)})
    gen = torch.Generator(device="cuda").manual_seed(21)
    chunk = (SEQTP_SEQ - 1) // SEQTP_RING
    full = {"causal": False, "offset": chunk}
    for case, (b, t, h, kh, d, pad_v, masks) in {
            "seqtp_600m_ring_diag": (RESUME_BATCH, chunk, 6, 3, 128, 0,
                                     {"causal": True}),
            "seqtp_600m_ring_full": (RESUME_BATCH, chunk, 6, 3, 128, 0,
                                     full),
            "seqtp_600m_ulysses": (RESUME_BATCH, 2 * chunk, 3, 3, 128, 0,
                                   {"causal": True}),
            "seqtp_v2lite_ring_diag": (2, chunk, 16, 16, 192, 64,
                                       {"causal": True}),
            "seqtp_v2lite_ring_full": (2, chunk, 16, 16, 192, 64, full),
            "seqtp_lora_8b_shard": (2, 2047, 16, 4, 128, 0,
                                    {"causal": True})}.items():
        x = [torch.randn(b, t, n, d, generator=gen, device="cuda").to(
            torch.bfloat16) for n in (h, kh, kh, h)]
        if pad_v:
            x[2][..., d - pad_v:] = 0
        check_kernels(torch, flash, case, *x, masks)
        del x
        torch.cuda.empty_cache()
    launches, bad = {}, []
    for sub, (model, layers, batch, seq, backends, (tp, ep), ring) in \
            SEQTP_CASES.items():
        t0 = time.perf_counter()
        for backend in backends:
            cfg, tkw = seqtp_config(model, layers, backend)
            it = synthetic_batches(batch, seq, cfg.vocab_size, seed=21)
            batches = [next(it) for _ in range(SEQTP_STEPS)]
            rings = (LocalSequenceGroup(ring),) if ring > 1 else ()
            groups = rings + tuple(
                g for g in (LocalTensorGroup(tp), LocalExpertGroup(ep))
                if g.size > 1)
            lora = getattr(cfg, "lora_rank", 0) > 0
            whole = tensor_run(torch, cfg, tkw, batches, rings, batch, seq,
                               lora=lora)
            split = tensor_run(torch, cfg, tkw, batches, groups, batch, seq,
                               lora=lora)
            d = head_dim_of(cfg)
            tag = f"{sub}_{backend}" if len(backends) > 1 else sub
            out, good = _split_summary(
                flash, tag, d, whole, split, tp,
                seqtp_launches(torch, cfg, backend, ring, SEQTP_STEPS),
                {"model": model, "backend": backend, "ring": ring,
                 "reduced": {"n_layers": [None, layers]} if layers else {},
                 "n_layers": cfg.n_layers, "batch_size": batch,
                 "seq_len": seq,
                 "heads_per_shard": [cfg.n_heads // tp,
                                     getattr(cfg, "n_kv_heads", cfg.n_heads)
                                     // tp],
                 "experts_per_shard": (cfg.n_experts // ep if ep > 1
                                       else None),
                 "device": kind, "nvidia_smi": smi})
            out["seq_tensor_summary"] = out.pop("tensor_summary")
            if lora:
                good &= whole["only_adapters_moved"]["ok"] and \
                    split["only_adapters_moved"]["ok"]
            emit(out)
            if not good:
                bad.append(tag)
            launches[tag] = split["launches"]
        PHASE_SECONDS[sub] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, good = seqtp_vit(torch, kind, smi)
    emit(out)
    if not good:
        bad.append("21d")
    launches["21d"] = out["split"]["launches"]
    PHASE_SECONDS["21d"] = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"phase 21: {bad} failed their checks")
    return launches


# The tile builds (phases 2-3, ``flash.BUILDS``): besides each head dim's
# path shapes, its D256/D192 cases and CHUNK_MODE, every build is held at
# the tile edges T = S of tests/test_flash_blocks.py's lengths and its own
# tiles (4 query / 2 kv heads, causal).
BUILD_EDGES = (64, 129, 200, 640, 768)


def tile_edge_checks(torch, flash, randn, builds) -> dict:
    """Every build of every head dim (``builds``: {d: overrides}) at
    BUILD_EDGES; {build name: max abs error}."""
    errs = {}
    for d, overrides in builds.items():
        for t in BUILD_EDGES:
            e, _, _ = check_kernels(
                torch, flash, f"tile_edge_d{d}_t{t}", randn(1, t, 4, d),
                randn(1, t, 2, d), randn(1, t, 2, d), randn(1, t, 4, d),
                {"causal": True}, builds=overrides)
            for name, x in e.items():
                errs[name] = max(errs.get(name, 0.0), x)
    return errs


def build_lines(flash, build_mod, report, timings, others) -> None:
    """One line per other tile build: its CUDA-event median at its head
    dim's path shapes, the bound (the default build's work), the default
    build's time, its ptxas report (registers, spills) and its block's
    dynamic shared memory (ptxas sees only static shared memory)."""
    for d, overrides in others.items():
        for tiles in overrides:
            for base, name in build_names(flash, d, tiles).items():
                if name == flash.kernel_name(base, d):
                    continue
                tm = timings[name]
                emit({"tile_build": name, "head_dim": d,
                      "tiles": list(flash.resolve_tiles(base, d, tiles)),
                      "ms": tm["ms"], "bound_ms": tm["bound_ms"],
                      "bound_share": tm["bound_share"],
                      "default_build": flash.kernel_name(base, d),
                      "default_build_ms": tm["default_build_ms"],
                      "ptxas": report[name]["kernels"],
                      "dynamic_smem_bytes": getattr(build_mod.library(name),
                                                    f"tpufw_{base}_smem")(),
                      "ptxas_lines": [
                          ln.strip() for ln in
                          build_mod.PTXAS_LOG.get(name, "").splitlines()
                          if "registers" in ln or "spill" in ln]})


def _launched(flash, before) -> dict:
    return {k: v - before[k] for k, v in flash.LAUNCHES.items()
            if v != before[k]}


def override_checks(torch, flash, randn) -> None:
    """The override reaches the kernels: a ``block_sizes=`` call launches
    the named builds and no other (head dims 128 and 256), and
    ``TPUFW_FLASH_BKV`` reaches the ring-flash chunks' launches (a
    two-shard ring at head dim 128: every chunk under the 64-key
    builds)."""
    from tpufw_torch.parallel.group import LocalSequenceGroup
    from tpufw_torch.parallel import ring_flash

    for d, tiles in ((128, (128, 64)), (256, (64, 64)), (192, (64, 64))):
        q = randn(1, 300, 4, d).requires_grad_()
        k, v = randn(1, 300, 2, d), randn(1, 300, 2, d)
        before = dict(flash.LAUNCHES)
        flash.flash_attention(q, k, v, block_sizes=tiles).float().sum(
        ).backward()
        torch.cuda.synchronize()
        got = _launched(flash, before)
        want = {name: 1 for name in build_names(flash, d, tiles).values()}
        emit({"check": f"override_kwarg_d{d}", "block_sizes": list(tiles),
              "launched": got})
        if got != want:
            raise AssertionError(f"block_sizes={tiles} at d{d} launched "
                                 f"{got}, want {want}")
    q = randn(1, 1024, 4, 128).requires_grad_()
    k = randn(1, 1024, 2, 128).requires_grad_()
    v = randn(1, 1024, 2, 128).requires_grad_()
    os.environ["TPUFW_FLASH_BKV"] = "64"
    try:
        ring_flash.reset_chunk_launches()
        before = dict(flash.LAUNCHES)
        ring_flash.ring_flash_attention(
            q, k, v, mesh=LocalSequenceGroup(2)).float().sum().backward()
        torch.cuda.synchronize()
    finally:
        del os.environ["TPUFW_FLASH_BKV"]
    got = _launched(flash, before)
    chunks = dict(ring_flash.CHUNK_LAUNCHES)
    emit({"check": "override_env_ring_flash", "TPUFW_FLASH_BKV": 64,
          "launched": got, "chunk_launches": chunks})
    k64 = set(build_names(flash, 128, (None, 64)).values())
    if not got or set(got) != k64 or not sum(chunks.values()):
        raise AssertionError(f"TPUFW_FLASH_BKV=64 ring-flash launched {got}"
                             f" ({chunks}), want only {sorted(k64)}")


# Phase 22 (item 13c on the card): 22a the memory estimate of
# llama3_600m_bench at B=RESUME_BATCH x RESUME_SEQ under TUNE_POLICIES
# beside one real step's peak; 22b train_llama with TPUFW_AUTOTUNE=search
# over TUNE_POLICIES x flash (default, the d128 64-key build), TUNE_STEPS
# timed steps a candidate within TUNE_BUDGET_S, then a run with
# TPUFW_AUTOTUNE=cached; 22c train_llama from the bench YAML of record
# with the env over it and PyYAML blocked; 22d the 64-row query builds of
# head dims 256 and 192 on their train paths (TILE_TRAIN_LAYERS layers of
# the Gemma-2-9B and MLA slices, TILE_TRAIN_STEPS steps) under
# TPUFW_FLASH_BQ=64.
TUNE_POLICIES = ("dots", "nothing")
TUNE_STEPS = 3
TUNE_BUDGET_S = 60.0
TUNE_TRAIN_STEPS = 3
TILE_TRAIN_LAYERS = 2
TILE_TRAIN_STEPS = 2


@contextlib.contextmanager
def _train_env(env: dict):
    """os.environ's TPUFW_* replaced by ``env`` for the block."""
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("TPUFW_")}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in list(os.environ):
            if k.startswith("TPUFW_"):
                del os.environ[k]
        os.environ.update(saved)


def _batches(torch, tcfg, vocab, n, seed=7):
    """``n`` synthetic batches of ``tcfg``'s shape, on the card."""
    from tpufw_torch.train import synthetic_batches

    it = synthetic_batches(tcfg.batch_size, tcfg.seq_len, vocab, seed=seed)
    return [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
            for _ in range(n)]


def memory_estimate_check(torch, kind, smi) -> None:
    """22a: ``estimate_train`` beside ``torch.cuda.max_memory_allocated``
    of one real step (init included) under each policy. Printed, not
    held: PERF.md records the ratio."""
    from tpufw_torch.configs import bench_model_config
    from tpufw_torch.tools.estimate_memory import estimate_train
    from tpufw_torch.train import Trainer, TrainerConfig

    for policy in TUNE_POLICIES:
        cfg = dataclasses.replace(bench_model_config(), remat_policy=policy)
        tcfg = TrainerConfig(batch_size=RESUME_BATCH, seq_len=RESUME_SEQ,
                             loss_chunk_size=512, handle_preemption=False)
        est = estimate_train(cfg, RESUME_BATCH, RESUME_SEQ,
                             remat_policy=policy, loss_chunk_size=512)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr = Trainer(cfg, tcfg, device="cuda")
        tr.init_state(seed=0)
        m = tr.train_step(_batches(torch, tcfg, cfg.vocab_size, 1)[0])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        emit({"memory_estimate": "llama3_600m_bench", "remat_policy": policy,
              "batch": RESUME_BATCH, "seq": RESUME_SEQ,
              "estimate": est.as_dict(), "estimate_bytes": est.total(),
              "measured_peak_bytes": peak,
              "estimate_over_measured": est.total() / peak,
              "loss": loss, "device": kind, "nvidia_smi": smi})
        if not math.isfinite(loss):
            raise AssertionError(f"22a {policy}: loss {loss}")
        del tr, m


def tune_run(torch, workdir: str, mode: str, steps: int) -> dict:
    """One 22b run: train_llama's build_trainer and Trainer.run with
    TPUFW_AUTOTUNE=``mode`` over 22b's space; the launch counts zeroed
    before the run and again when the tuner returns, so the second count
    is the tuned run's own."""
    from tpufw_torch.ops import flash
    from tpufw_torch.tune import runner, space
    from tpufw_torch.workloads import train_llama

    tel_dir = os.path.join(workdir, f"tel_{mode}")
    env = {"TPUFW_MODEL": "llama3_600m_bench",
           "TPUFW_BATCH_SIZE": str(RESUME_BATCH),
           "TPUFW_SEQ_LEN": str(RESUME_SEQ), "TPUFW_TOTAL_STEPS": str(steps),
           "TPUFW_LOG_EVERY": "1", "TPUFW_LOSS_CHUNK_SIZE": "512",
           "TPUFW_AUTOTUNE": mode, "TPUFW_AUTOTUNE_STEPS": str(TUNE_STEPS),
           "TPUFW_AUTOTUNE_BUDGET_S": str(TUNE_BUDGET_S),
           "TPUFW_TUNE_CACHE_DIR": os.path.join(workdir, "tune"),
           "TPUFW_TELEMETRY_DIR": tel_dir}
    small = space.SearchSpace(remat_policies=TUNE_POLICIES, grad_accums=(1,),
                              loss_chunk_sizes=(512,),
                              flash_blocks=(None, (128, 64)),
                              sync_everys=(1,))
    tuner, default_space = runner.apply_autotune, space.DEFAULT_SPACE
    counts = {}

    def tune_then_zero(*a, **kw):
        res = tuner(*a, **kw)
        torch.cuda.synchronize()
        counts["tune"] = dict(flash.LAUNCHES)
        flash.reset_launch_counts()
        return res

    with _train_env(env):
        space.DEFAULT_SPACE, runner.apply_autotune = small, tune_then_zero
        try:
            trainer, cfg = train_llama.build_trainer()
            trainer.init_state(seed=0)
            batches = _batches(torch, trainer.cfg, cfg.vocab_size, steps)
            torch.cuda.synchronize()
            flash.reset_launch_counts()
            t0 = time.perf_counter()
            history = trainer.run(iter(batches),
                                  cfg.flops_per_token(RESUME_SEQ - 1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            space.DEFAULT_SPACE, runner.apply_autotune = default_space, tuner
    events = [json.loads(ln) for ln in open(os.path.join(
        tel_dir, "events.jsonl"))]
    out = {"history": history, "tune": trainer.last_tune,
           "tune_launches": {k: v for k, v in counts.get("tune", {}).items()
                             if v},
           "run_launches": {k: v for k, v in flash.LAUNCHES.items() if v},
           "events": [e for e in events if e["kind"].startswith("tune_")],
           "wall_s": wall, "remat_policy": trainer.model_cfg.remat_policy}
    del trainer, batches
    return out


def tuner_check(torch, kind, smi, workdir: str) -> dict:
    """22b: the search measures >= 2 trials and installs its winner (the
    tuned run's launches fall under the winner's builds), a cached run
    measures nothing. Returns the search run's launches (trials and
    steps) of every build."""
    from tpufw_torch.ops import flash

    found = tune_run(torch, workdir, "search", TUNE_TRAIN_STEPS)
    res = found["tune"]
    trials = [{"candidate": t.candidate.as_dict(), "status": t.status,
               "median_step_ms": None if t.median_step_s is None
               else t.median_step_s * 1e3, "error": t.error}
              for t in res.trials]
    winner = res.best
    tiles = (winner.flash_bq, winner.flash_bkv)
    want = set(build_names(flash, 128, tiles).values())
    losses = [m.loss for m in found["history"]]
    emit({"tune_summary": "search", "trials": trials,
          "result": res.summary(), "winner_builds": sorted(want),
          "run_launches": found["run_launches"],
          "tune_launches": found["tune_launches"],
          "remat_policy_installed": found["remat_policy"],
          "events": [e["kind"] for e in found["events"]], "losses": losses,
          "wall_s": found["wall_s"], "device": kind, "nvidia_smi": smi})
    measured = [t for t in res.trials if t.status == "ok"]
    if len(measured) < 2:
        raise AssertionError(f"22b: {len(measured)} measured trials")
    if "tune_result" not in [e["kind"] for e in found["events"]]:
        raise AssertionError("22b: no tune_result event")
    if set(found["run_launches"]) != want:
        raise AssertionError(f"22b: the tuned run launched "
                             f"{found['run_launches']}, winner's {want}")
    if found["remat_policy"] != winner.remat_policy:
        raise AssertionError("22b: the winner's remat policy not installed")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"22b: losses {losses}")
    k64 = build_names(flash, 128, (None, 64)).values()
    if not all(found["tune_launches"].get(n) for n in k64):
        raise AssertionError(f"22b: the 64-key builds were not measured: "
                             f"{found['tune_launches']}")
    cached = tune_run(torch, workdir, "cached", 1)
    emit({"tune_summary": "cached", "result": cached["tune"].summary(),
          "run_launches": cached["run_launches"], "wall_s": cached["wall_s"]})
    if not cached["tune"].cache_hit or cached["tune"].trials:
        raise AssertionError("22b: the cached run did not hit the cache")
    if cached["tune"].best != winner:
        raise AssertionError("22b: the cache holds another winner")
    launches = dict(found["tune_launches"])
    for k, v in found["run_launches"].items():
        launches[k] = launches.get(k, 0) + v
    return launches


def yaml_config_check(torch, kind, smi) -> None:
    """22c: train_llama from deploy/configs/bench-v5e1.yaml with
    TPUFW_BATCH_SIZE and TPUFW_TOTAL_STEPS over the file, PyYAML blocked
    (an ``import yaml`` raises), as on a machine without it."""
    from tpufw_torch.workloads import train_llama

    import importlib.util

    had_yaml = importlib.util.find_spec("yaml") is not None
    env = {"TPUFW_CONFIG": os.path.join(ROOT, "deploy", "configs",
                                        "bench-v5e1.yaml"),
           "TPUFW_BATCH_SIZE": str(RESUME_BATCH),
           "TPUFW_TOTAL_STEPS": "3"}
    saved = sys.modules.get("yaml", None)
    sys.modules["yaml"] = None
    try:
        with _train_env(env):
            trainer, cfg = train_llama.build_trainer()
            trainer.init_state(seed=0)
            batches = _batches(torch, trainer.cfg, cfg.vocab_size, 3)
            history = trainer.run(iter(batches),
                                  cfg.flops_per_token(trainer.cfg.seq_len
                                                      - 1))
    finally:
        if saved is None:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = saved
    losses = [m.loss for m in history]
    tc = trainer.cfg
    resolved = {"remat_policy": cfg.remat_policy, "n_layers": cfg.n_layers,
                "batch_size": tc.batch_size, "total_steps": tc.total_steps,
                "seq_len": tc.seq_len, "loss_chunk_size": tc.loss_chunk_size,
                "lr": tc.lr, "warmup_steps": tc.warmup_steps}
    emit({"yaml_config_summary": "bench-v5e1.yaml", "resolved": resolved,
          "losses": losses, "pyyaml_installed": had_yaml,
          "pyyaml_blocked": True, "device": kind, "nvidia_smi": smi})
    want = {"remat_policy": "nothing", "n_layers": 14,
            "batch_size": RESUME_BATCH, "total_steps": 3, "seq_len": 2048,
            "loss_chunk_size": 512, "lr": 1e-4, "warmup_steps": 2}
    if resolved != want or len(losses) != 3 or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"22c: {resolved} {losses}")
    del trainer, batches


def tile_train_check(torch, kind, smi) -> dict:
    """22d: the 64-row query builds on the Gemma-2-9B and MLA train paths
    (TILE_TRAIN_LAYERS layers, TILE_TRAIN_STEPS steps through Trainer.run)
    under TPUFW_FLASH_BQ=64, the counts zeroed just before each run: every
    launch under the 64-row forward and dQ builds and the head dim's
    dK/dV build, the losses finite. Returns the launches."""
    from tpufw_torch import configs
    from tpufw_torch.ops import flash
    from tpufw_torch.train import Trainer

    launches = {}
    for slice_fn, d in ((configs.gemma2_9b_train_slice, 256),
                        (configs.deepseek_mla_train_slice, 192)):
        cfg, tcfg = slice_fn(n_layers=TILE_TRAIN_LAYERS,
                             total_steps=TILE_TRAIN_STEPS)
        tcfg = dataclasses.replace(tcfg, handle_preemption=False)
        with _train_env({"TPUFW_FLASH_BQ": "64"}):
            tr = Trainer(cfg, tcfg, device="cuda")
            tr.init_state(seed=0)
            batches = _batches(torch, tcfg, cfg.vocab_size,
                               TILE_TRAIN_STEPS)
            torch.cuda.synchronize()
            flash.reset_launch_counts()
            history = tr.run(iter(batches), cfg.flops_per_token(
                tcfg.seq_len - 1))
            torch.cuda.synchronize()
        got = {k: v for k, v in flash.LAUNCHES.items() if v}
        want = set(build_names(flash, d, (64, None)).values())
        losses = [m.loss for m in history]
        emit({"tile_train_summary": f"d{d}", "TPUFW_FLASH_BQ": 64,
              "layers": TILE_TRAIN_LAYERS, "launches": got,
              "losses": losses, "step_s": [m.step_time_s for m in history],
              "device": kind, "nvidia_smi": smi})
        if set(got) != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"22d d{d}: launched {got}, want {want}; "
                                 f"losses {losses}")
        launches |= got
        del tr, batches
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def autotune_phase(torch, kind, smi) -> dict:
    """Phase 22: 22a-22d, each timed into PHASE_SECONDS. Returns the
    launches of the other tile builds on 22b's and 22d's runs."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build-torch"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="phase22-", dir=os.path.join(
        ROOT, "build-torch"))
    try:
        _timed("22a", lambda: memory_estimate_check(torch, kind, smi))
        gc.collect()
        torch.cuda.empty_cache()
        launches = _timed("22b", lambda: tuner_check(torch, kind, smi,
                                                     workdir))
        gc.collect()
        torch.cuda.empty_cache()
        _timed("22c", lambda: yaml_config_check(torch, kind, smi))
        gc.collect()
        torch.cuda.empty_cache()
        launches |= _timed("22d", lambda: tile_train_check(torch, kind, smi))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


# Phase 23: the smoke workload at its defaults, and the limit of the
# lint's run on the card.
SMOKE_DIM, SMOKE_REPS = 4096, 20
SMOKE_TIMEOUT_S = 300
LINT_TIMEOUT_S = 180
VALIDATE_GATES = ("NVIDIA device nodes mounted", "libcuda.so.1 loadable",
                  "torch enumerates CUDA devices")


def _run_child(args, timeout):
    """``python args`` from the checkout's root with no TPUFW_* knob set:
    (completed process, wall seconds)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFW_")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return res, time.perf_counter() - t0


def smoke_check(kind, smi) -> None:
    """23a: the smoke workload as a user runs it, at its defaults."""
    import re

    res, wall = _run_child(["-m", "tpufw_torch.workloads.smoke"],
                       SMOKE_TIMEOUT_S)
    out = res.stdout
    mm = re.search(r"matmul\[(\d+)x\d+\] checksum=(\S+) "
                   r"time=(\S+)ms/iter \((\S+) effective TFLOP/s\)", out)
    devs = re.search(r"torch\.cuda devices -> (.*) count=(\d+)", out)
    summary = {"smoke_summary": "tpufw_torch.workloads.smoke",
               "rc": res.returncode, "wall_s": wall,
               "dim": int(mm.group(1)) if mm else None, "reps": SMOKE_REPS,
               "checksum": float(mm.group(2)) if mm else None,
               "ms_per_iter": float(mm.group(3)) if mm else None,
               "effective_tflops": float(mm.group(4)) if mm else None,
               "devices": devs.group(1) if devs else None,
               "device_count": int(devs.group(2)) if devs else None,
               "device": kind, "nvidia_smi": smi}
    emit(summary)
    if res.returncode != 0 or "SMOKE OK" not in out:
        raise AssertionError(
            f"23a smoke rc {res.returncode}: {(out + res.stderr)[-2000:]}")
    if not devs or int(devs.group(2)) < 1 or kind not in devs.group(1) \
            or "platform: cuda" not in out:
        raise AssertionError(f"23a smoke: no CUDA device line in {out!r}")
    if not mm or int(mm.group(1)) != SMOKE_DIM \
            or not math.isfinite(float(mm.group(2))) \
            or not float(mm.group(4)) > 0:
        raise AssertionError(f"23a smoke: bad matmul line in {out!r}")


def validate_check(kind, smi) -> None:
    """23b: the validate ladder in this process. The allocation env is
    printed, not held: outside Kubernetes nothing injects it."""
    from tpufw_torch.workloads import validate

    results = dict(validate.run_checks())
    emit({"validate_summary": "tpufw_torch.workloads.validate",
          "checks": results,
          "NVIDIA_VISIBLE_DEVICES": os.environ.get("NVIDIA_VISIBLE_DEVICES"),
          "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
          "nodes": sorted(glob.glob("/dev/nvidia*")),
          "device": kind, "nvidia_smi": smi})
    failed = [g for g in VALIDATE_GATES if not results.get(g)]
    if failed:
        raise AssertionError(f"23b validate failed {failed}: {results}")


def lint_check(kind, smi) -> None:
    """23c: the port's lint over the package under the card's Python, and
    the lint's CLI imported in a child without torch or JAX."""
    res, lint_s = _run_child(["-m", "tpufw_torch.analysis", "--layer",
                              "python", "tpufw_torch"], LINT_TIMEOUT_S)
    probe, _ = _run_child(["-c", (
        "import sys\n"
        "import tpufw_torch.analysis.__main__\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'flax', 'tpufw')))\n")], 60)
    lines = res.stdout.strip().splitlines()
    emit({"lint_summary": "python -m tpufw_torch.analysis --layer python "
                          "tpufw_torch",
          "rc": res.returncode, "seconds": lint_s,
          "last_line": lines[-1] if lines else "",
          "findings": len(lines) - 1 if res.returncode == 1 else 0,
          "python": sys.version.split()[0],
          "import_probe_rc": probe.returncode,
          "import_probe_loaded": probe.stdout.strip(),
          "device": kind, "nvidia_smi": smi})
    if res.returncode != 0:
        raise AssertionError(
            f"23c lint rc {res.returncode}: {(res.stdout + res.stderr)[-3000:]}")
    if probe.returncode != 0 or probe.stdout.strip() != "[]":
        raise AssertionError(
            f"23c: the lint's CLI loaded {probe.stdout!r} {probe.stderr!r}")


def workload_lint_phase(kind, smi) -> None:
    """Phase 23: 23a-23c, each timed into PHASE_SECONDS."""
    _timed("23a", lambda: smoke_check(kind, smi))
    _timed("23b", lambda: validate_check(kind, smi))
    _timed("23c", lambda: lint_check(kind, smi))


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not os.path.isfile(
        os.path.join(ROOT, "tpufw_torch", "ops", "csrc", "flash_fwd.cu")
    ):
        return fail("run from a checkout of the repo (tpufw_torch/ missing)")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpufw_torch.ops import _build, flash
    from tpufw_torch.utils.hardware import detect_chip

    # 1. Build and device line.
    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    chip = detect_chip("cuda")
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    PHASE_SECONDS["1"] = build_s
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in _build.PTXAS_LOG.items()
    }
    emit({"device": kind, "nvidia_smi": smi, "chip_spec": chip.name,
          "build_s": build_s, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    try:
        report = build_report(_build, paths)
    except AssertionError as e:
        return fail(str(e))
    emit({"build_report": report})
    # The other tile builds of each head dim (the tile override's values a
    # train step takes), held beside the default builds in every case of
    # their head dim.
    others = {d: flash.tile_choices(d) for d in flash.BUILDS}
    all_builds = {d: (None, *others[d]) for d in flash.BUILDS}
    # 2. Kernels vs plain versions.
    t_phase = time.perf_counter()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        x = torch.randn(*shape, generator=gen, device=dev) * scale
        return x.to(torch.bfloat16)

    b, t, h, kh, d = 2, 2047, 32, 8, 128
    q, do = randn(b, t, h, d), randn(b, t, h, d)
    k, v = randn(b, t, kh, d), randn(b, t, kh, d)
    errs, lse, delta = check_kernels(
        torch, flash, "path_shapes_causal", q, k, v, do, {"causal": True},
        builds=all_builds[128])
    # Small cases, 4 query / 2 kv heads: name, (b, t, s, input scale,
    # masks, segment lengths over the s keys or None).
    small = {
        "segments_offset_window300_cap50": (
            1, 300, 700, 4.0, {"causal": True, "window": 300, "soft_cap": 50.0},
            (250, 300, 150)),
        "t129_s129": (1, 129, 129, 1.0, {"causal": True}, None),
        "t64_s64": (1, 64, 64, 1.0, {"causal": True}, None),
        "b2_t700_s700": (2, 700, 700, 1.0, {"causal": True}, None),
        "b2_t700_s700_noncausal": (2, 700, 700, 1.0, {"causal": False}, None),
        "t100_s300_offset": (1, 100, 300, 1.0, {"causal": True}, None),
        "window128": (1, 600, 600, 1.0, {"causal": True, "window": 128}, None),
        "window129": (1, 600, 600, 1.0, {"causal": True, "window": 129}, None),
        "segments_mid_tile": (2, 400, 400, 1.0, {"causal": True},
                              (50, 140, 143, 67)),
        **{name: (2, 600, 600, 1.0, masks, None)
           for name, masks in CHUNK_MODE.items()},
    }
    for case, (bs, ts, ss, scale, masks, seg_lens) in small.items():
        masks = case_masks(torch, masks, seg_lens, bs, ts, ss)
        check_kernels(
            torch, flash, case,
            randn(bs, ts, 4, d, scale=scale), randn(bs, ss, 2, d, scale=scale),
            randn(bs, ss, 2, d), randn(bs, ts, 4, d), masks,
            builds=all_builds[128])

    # 2b. The head-dim-256 kernels (Gemma-2) at the Gemma train path's
    # shapes and at their own tile edges.
    d256_inputs = {}
    for case, (bs, ts, ss, hs, khs, scale, masks, seg_lens) in D256_CASES.items():
        masks = case_masks(torch, masks, seg_lens, bs, ts, ss)
        qd, dod = randn(bs, ts, hs, 256, scale=scale), randn(bs, ts, hs, 256)
        kd, vd = randn(bs, ss, khs, 256, scale=scale), randn(bs, ss, khs, 256)
        e, lse_d, delta_d = check_kernels(torch, flash, case, qd, kd, vd, dod,
                                          masks, builds=all_builds[256])
        if ts == GEMMA_T:
            for name, x in e.items():
                errs[name] = max(errs.get(name, 0.0), x)
            if "window" not in masks:
                d256_inputs = dict(q=qd, k=kd, v=vd, do=dod, lse=lse_d,
                                   delta=delta_d)
        del qd, dod, kd, vd, lse_d, delta_d
        torch.cuda.empty_cache()

    # 2c. The head-dim-192 kernels (DeepSeek MLA) at the MLA train path's
    # shapes, V zero-padded as the model gives it and random, and at their
    # tile edges.
    d192_inputs = {}
    for case, (bs, ts, ss, hs, khs, scale, masks, seg_lens) in D192_CASES.items():
        masks = dict(masks)
        pad_v = masks.pop("pad_v", 0)
        masks = case_masks(torch, masks, seg_lens, bs, ts, ss)
        qd, dod = randn(bs, ts, hs, 192, scale=scale), randn(bs, ts, hs, 192)
        kd, vd = randn(bs, ss, khs, 192, scale=scale), randn(bs, ss, khs, 192)
        if pad_v:
            vd[..., 192 - pad_v:] = 0
        e, lse_d, delta_d = check_kernels(torch, flash, case, qd, kd, vd, dod,
                                          masks, builds=all_builds[192])
        if ts == MLA_T:
            for name, x in e.items():
                errs[name] = max(errs.get(name, 0.0), x)
            if pad_v:
                d192_inputs = dict(q=qd, k=kd, v=vd, do=dod, lse=lse_d,
                                   delta=delta_d)
        del qd, dod, kd, vd, lse_d, delta_d
        torch.cuda.empty_cache()

    # 3. Timings at the paths' shapes: head dim 128 at the Llama train
    # slice's, head dim 256 at the Gemma-2 one's, global and windowed, and
    # head dim 192 at the MLA one's.
    timings = time_kernels(torch, flash, chip, q, k, v, do, lse, delta)
    for tiles in others[128]:
        timings |= time_kernels(torch, flash, chip, q, k, v, do, lse, delta,
                                block_sizes=tiles, yardsticks=timings)
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    # 2d/3d. Head dim 128 at phase 7b's shapes too (llama3_600m_bench: B=4,
    # T=S=2047, 12/6 heads), checked and timed.
    b6, h6, kh6 = RESUME_BATCH, 12, 6
    q, do = randn(b6, RESUME_SEQ - 1, h6, d), randn(b6, RESUME_SEQ - 1, h6, d)
    k, v = (randn(b6, RESUME_SEQ - 1, kh6, d), randn(b6, RESUME_SEQ - 1, kh6, d))
    e600, lse, delta = check_kernels(torch, flash, "resume_600m_shapes_causal",
                                     q, k, v, do, {"causal": True})
    at600 = time_kernels(torch, flash, chip, q, k, v, do, lse, delta,
                         label="_600m")
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    x = d256_inputs
    timings |= time_kernels(torch, flash, chip, x["q"], x["k"], x["v"], x["do"],
                            x["lse"], x["delta"],
                            {"causal": True, "soft_cap": GEMMA_ATTN_CAP})
    for tiles in others[256]:
        timings |= time_kernels(
            torch, flash, chip, x["q"], x["k"], x["v"], x["do"], x["lse"],
            x["delta"], {"causal": True, "soft_cap": GEMMA_ATTN_CAP},
            block_sizes=tiles, yardsticks=timings)
    # LSE and delta of the global case serve the windowed timing too: they
    # are inputs of the same shape, and the kernels' time does not depend
    # on their values.
    windowed = time_kernels(
        torch, flash, chip, x["q"], x["k"], x["v"], x["do"], x["lse"],
        x["delta"], {"causal": True, "soft_cap": GEMMA_ATTN_CAP,
                     "window": GEMMA_WINDOW}, label="_window4096")
    del x, d256_inputs
    torch.cuda.empty_cache()
    # Head dim 192 at the MLA path's shapes, with the model's zero-padded V.
    x = d192_inputs
    timings |= time_kernels(torch, flash, chip, x["q"], x["k"], x["v"], x["do"],
                            x["lse"], x["delta"])
    for tiles in others[192]:
        timings |= time_kernels(
            torch, flash, chip, x["q"], x["k"], x["v"], x["do"], x["lse"],
            x["delta"], block_sizes=tiles, yardsticks=timings)
    sdpa_v128 = sdpa_unequal_v(torch, x["q"], x["k"], x["v"], MLA_V)
    emit({"timing": "sdpa_mla_unpadded_v", "shape": list(x["q"].shape)}
         | sdpa_v128)
    del x, d192_inputs
    torch.cuda.empty_cache()

    # 2e. Every build at the tile edges, the override's reach, and one
    # line per other build.
    t_builds = time.perf_counter()
    try:
        tile_edge_checks(torch, flash, randn, all_builds)
        override_checks(torch, flash, randn)
    except AssertionError as e:
        return fail(str(e))
    build_lines(flash, _build, report, timings, others)
    torch.cuda.empty_cache()
    PHASE_SECONDS["2e"] = time.perf_counter() - t_builds
    PHASE_SECONDS["2-3"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 4. The train slice, counters zeroed just before; 4b. the Gemma-2-9B
    # one and 4c. the DeepSeek MLA one (all 10 layers), each with its own
    # counters zeroed just before it.
    # The Llama slice first at the default remat policy ("dots"): its
    # counts are the kernels line's; then the other policies, and a run at
    # sync_every=4.
    try:
        launches, dots_losses = train_phase(torch, "llama3_8b", N_LAYERS, gen,
                                            kind, smi, evaluate=True)
        torch.cuda.empty_cache()
        remat_sweep(torch, gen, kind, smi, dots_losses)
        sync_window_run(torch, kind, smi)
        torch.cuda.empty_cache()
        launches |= train_phase(torch, "gemma2_9b", GEMMA_TRAIN_LAYERS, gen,
                                kind, smi)[0]
        torch.cuda.empty_cache()
        launches |= train_phase(torch, "deepseek_mla", MLA_TRAIN_LAYERS, gen,
                                kind, smi)[0]
    except AssertionError as e:
        return fail(str(e))
    torch.cuda.empty_cache()

    PHASE_SECONDS["4"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 5. The serve slice, with the train phases' memory freed; 5b. the
    # Gemma-2-9B serve slice; 5c. the DeepSeek MLA one (latent cache).
    try:
        serve_phase(torch, chip, kind, smi, n_layers=LLAMA_SERVE_LAYERS)
        torch.cuda.empty_cache()
        serve_phase(torch, chip, kind, smi, family="gemma2_9b",
                    n_layers=GEMMA_SERVE_LAYERS)
        torch.cuda.empty_cache()
        serve_phase(torch, chip, kind, smi, family="deepseek_mla")
    except AssertionError as e:
        return fail(str(e))

    PHASE_SECONDS["5"] = time.perf_counter() - t_phase

    # 6. The online server, with phase 5's models freed.
    torch.cuda.empty_cache()
    try:
        _timed("6", lambda: online_phase(torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 7. Weights and state, with phase 6's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        resume_launches = _timed("7", lambda: weights_phase(torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 8. Disaggregated serving, with phase 7's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _timed("8", lambda: disaggregated_phase(torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 9. Mixtral, with phase 8's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        mixtral_launches = _timed("9", lambda: mixtral_phase(
            torch, chip, kind, smi, gen))
    except AssertionError as e:
        return fail(str(e))

    # 10. DeepSeek-V2-Lite, with phase 9's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        v2lite_launches = _timed("10", lambda: v2lite_phase(
            torch, chip, kind, smi, gen))
    except AssertionError as e:
        return fail(str(e))

    # 11. LoRA, with phase 10's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        lora_launches, mixtral_lora_launches, lora_losses = _timed(
            "11", lambda: lora_phase(torch, kind, smi, gen))
    except AssertionError as e:
        return fail(str(e))

    # 12. Vision, with phase 11's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        vision_refs = _timed("12", lambda: vision_phase(torch, chip, kind,
                                                        smi))
    except AssertionError as e:
        return fail(str(e))

    # 13. Post-training, with phase 12's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        post_launches, post_refs = _timed("13", lambda: post_train_phase(
            torch, kind, smi, gen))
    except AssertionError as e:
        return fail(str(e))

    # 14. The mesh on the card, with phase 13's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        mesh_launches = _timed("14", lambda: mesh_phase(
            torch, kind, smi, lora_losses))
    except AssertionError as e:
        return fail(str(e))

    # 15. Sequence parallelism, with phase 14's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        seq_launches = _timed("15", lambda: sequence_phase(
            torch, kind, smi, gen))
    except AssertionError as e:
        return fail(str(e))

    # 16. Pipeline parallelism, with phase 15's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        pipe_launches = _timed("16", lambda: pipeline_phase(torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 17. GRPO, embeddings and vision under the mesh, with phase 16's
    # models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        gang_post_launches = _timed("17", lambda: gang_post_phase(
            torch, chip, kind, smi, vision_refs, post_refs, post_launches))
    except AssertionError as e:
        return fail(str(e))
    del vision_refs, post_refs

    # 18. Tensor and expert shards, with phase 17's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        tensor_launches = _timed("18", lambda: tensor_phase(torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 19. The post-trainers and the pipelines over tensor and expert
    # shards, with phase 18's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        tensor_pipe_launches = _timed("19", lambda: tensor_pipe_phase(
            torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 20. Telemetry: the train step counted, profiled and scraped against
    # the same run without telemetry, then the server's telemetry, with
    # phase 19's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        telemetry_launches = _timed("20", lambda: telemetry_phase(
            torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 21. The tensor and expert axes beside a sequence ring, under LoRA
    # and in the vision trainer, with phase 20's models freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        seq_tensor_launches = _timed("21", lambda: seq_tensor_phase(
            torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 22. Item 13c: the memory estimate, the tuner, the YAML run config and
    # the 64-row query builds on their train paths, with phase 21's models
    # freed.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        tile_launches = _timed("22", lambda: autotune_phase(torch, kind, smi))
    except AssertionError as e:
        return fail(str(e))

    # 23. The smoke and validate workloads and the port's lint, with phase
    # 22's models freed (the smoke's child needs the card's memory).
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _timed("23", lambda: workload_lint_phase(kind, smi))
    except (AssertionError, subprocess.TimeoutExpired) as e:
        return fail(str(e))

    tpu_lines = {"flash_fwd": "tpufw/ops/flash.py:462",
                 "flash_dq": "tpufw/ops/flash.py:544",
                 "flash_dkv": "tpufw/ops/flash.py:590"}
    replaces = {
        "flash_fwd": ("tpufw_torch/ops/csrc/flash_fwd.cu", "tpufw/ops/flash.py:462"),
        "flash_dq": ("tpufw_torch/ops/csrc/flash_dq.cu", "tpufw/ops/flash.py:544"),
        "flash_dkv": ("tpufw_torch/ops/csrc/flash_dkv.cu", "tpufw/ops/flash.py:590"),
        "flash_fwd_d192": ("tpufw_torch/ops/csrc/flash_fwd_d192.cu",
                           "tpufw/ops/flash.py:462"),
        "flash_dq_d192": ("tpufw_torch/ops/csrc/flash_dq_d192.cu",
                          "tpufw/ops/flash.py:544"),
        "flash_dkv_d192": ("tpufw_torch/ops/csrc/flash_dkv_d192.cu",
                           "tpufw/ops/flash.py:590"),
        "flash_fwd_d256": ("tpufw_torch/ops/csrc/flash_fwd_d256.cu",
                           "tpufw/ops/flash.py:462"),
        "flash_dq_d256": ("tpufw_torch/ops/csrc/flash_dq_d256.cu",
                          "tpufw/ops/flash.py:544"),
        "flash_dkv_d256": ("tpufw_torch/ops/csrc/flash_dkv_d256.cu",
                           "tpufw/ops/flash.py:590"),
        # The other tile builds: their launches are phase 22's (22b's
        # tuner trials and tuned steps at head dim 128, 22d's train runs
        # at 192 and 256).
        **{name: (f"tpufw_torch/ops/csrc/{name}.cu",
                  tpu_lines[flash.base_kernel(name)])
           for name in flash.LAUNCHES if name.endswith(("_k64", "_q64"))},
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        tm = timings[name]
        n_launches = launches[name] if name in launches else \
            tile_launches.get(name, 0)
        if not n_launches:
            return fail(f"{name}: no launch on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": n_launches, "max_abs_err": errs[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        })
        if name in mixtral_launches:
            # Phase 9a's runs, Mixtral-8x7B widths, per dispatch mode.
            kernels[-1]["launches_mixtral_train"] = mixtral_launches[name]
        if name in v2lite_launches:
            # Phase 10a's runs, DeepSeek-V2-Lite widths, per dispatch mode.
            kernels[-1]["launches_v2lite_train"] = v2lite_launches[name]
        if name in lora_launches:
            # Phase 11a's run, Llama-3-8B LoRA at 32 layers, and 11b's
            # Mixtral LoRA runs per dispatch mode.
            kernels[-1]["launches_lora_train"] = lora_launches[name]
            kernels[-1]["launches_mixtral_lora_train"] = \
                mixtral_lora_launches[name]
        if name in post_launches["sft"]:
            # Phase 13's runs, by sub-phase (GRPO's decode, scoring and
            # updates apart).
            kernels[-1]["launches_post_train"] = {
                part: counts[name] for part, counts in post_launches.items()}
        if name in mesh_launches["600m"]:
            # Phase 14's sharded runs: 14a llama3_600m_bench, 14b the
            # Llama-3-8B LoRA slice.
            kernels[-1]["launches_mesh"] = {
                part: counts[name] for part, counts in mesh_launches.items()}
            # Phase 17's sharded runs: 17a GRPO's decode, scoring and
            # updates apart, 17b each embedding recipe.
            kernels[-1]["launches_gang_post"] = {
                part: counts[name]
                for part, counts in gang_post_launches.items()}
        # Phase 15's runs: 15a's one-process rings and Ulysses, 15b's
        # ring and ulysses trainers (one shard).
        kernels[-1]["launches_sequence"] = {
            part: counts.get(name, 0) for part, counts in seq_launches.items()}
        # Phase 18's split runs: 18a llama3_600m_bench (d128), 18b the
        # V2-Lite slice (d192), 18c the Gemma-2-9B slice (d256).
        kernels[-1]["launches_tensor"] = {
            part: counts.get(name, 0)
            for part, counts in tensor_launches.items()}
        # Phase 19's split runs: 19a the post-trainers of
        # llama3_600m_bench (d128), 19b its pipelines, 19c
        # deepseek_mla_bench's (d192), 19d the V2-Lite slice's.
        kernels[-1]["launches_tensor_post_pipeline"] = {
            part: counts.get(name, 0)
            for part, counts in tensor_pipe_launches.items()}
        # Phase 21's split runs: 21a llama3_600m_bench beside a ring
        # (ring, ulysses; d128), 21b the V2-Lite slice beside it (d192),
        # 21c the Llama-3-8B LoRA slice (d128), 21d ViT-B/16 (none).
        kernels[-1]["launches_seq_tensor"] = {
            part: counts.get(name, 0)
            for part, counts in seq_tensor_launches.items()}
        # Phase 16's runs, by sub-phase and schedule (16a llama3_600m_bench
        # at head dim 128, 16b deepseek_mla_bench at 192), 4 steps each.
        kernels[-1]["launches_pipeline"] = {
            part: counts.get(name, 0) for part, counts in pipe_launches.items()}
        if name in telemetry_launches["20a"]:
            # Phase 20's runs of llama3_600m_bench through train_llama,
            # 20a with telemetry, 20b without.
            kernels[-1]["launches_telemetry"] = {
                part: counts[name]
                for part, counts in telemetry_launches.items()}
        if name in resume_launches:
            # Phase 7b's run, llama3_600m_bench through Trainer.run, and
            # the kernel at its shapes.
            kernels[-1]["launches_resume_600m"] = resume_launches[name]
            kernels[-1]["at_600m_shapes"] = {"max_abs_err": e600[name]} | {
                k: at600[name][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")}
        if name.endswith("_d192"):
            # SDPA on MLA's own V (128 columns, no padding).
            kernels[-1]["library_ms_unpadded_v"] = sdpa_v128[
                "fwd_ms" if name == "flash_fwd_d192" else "bwd_ms"]
        if name in windowed:
            # The Gemma path runs half its layers windowed: their numbers.
            kernels[-1]["window4096"] = {
                k: windowed[name][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            }
    emit({"kernels": kernels})
    PHASE_SECONDS["total"] = time.perf_counter() - t_start
    emit({"phase_seconds": PHASE_SECONDS})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
