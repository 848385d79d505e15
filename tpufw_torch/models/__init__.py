from tpufw_torch.models.gemma import (  # noqa: F401
    GEMMA_CONFIGS,
    Gemma,
    GemmaConfig,
    model_for_config,
)
from tpufw_torch.models.llama import (  # noqa: F401
    LLAMA_CONFIGS,
    KVCache,
    Llama,
    LlamaConfig,
    PagedKVCache,
    QuantProjection,
    RopeScaling,
)
