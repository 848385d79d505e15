"""Inference: KV-cache generation, sampling, speculative decoding, the slot
pool, the paged pool with chunked prefill, the prefix trie and the host
spill tier behind it (``tpufw_torch.infer.spill``) (port of
``tpufw.infer``)."""

from tpufw_torch.infer.generate import (  # noqa: F401
    cast_decode_params,
    generate,
    generate_stream,
    generate_text,
    generate_text_stream,
    pad_prompts,
    prefill_cache,
)
from tpufw_torch.infer.sampling import (  # noqa: F401
    SamplingConfig,
    apply_min_p,
    apply_repetition_penalty,
    apply_top_k,
    apply_top_p,
    sample_token,
    transform_logits,
)
from tpufw_torch.infer.speculative import (  # noqa: F401
    AcceptEMA,
    ngram_propose,
    speculative_generate,
    speculative_generate_text,
)
from tpufw_torch.infer.slots import (  # noqa: F401
    SlotPool,
    pool_cache,
    prefill_row,
)
from tpufw_torch.infer.pages import (  # noqa: F401
    ChunkedPrefill,
    PageAllocator,
    PagedSlotPool,
)
from tpufw_torch.infer.prefix import PrefixCache  # noqa: F401
