from tpufw_torch.models.llama import (  # noqa: F401
    LLAMA_CONFIGS,
    KVCache,
    Llama,
    LlamaConfig,
    PagedKVCache,
    QuantProjection,
    RopeScaling,
)
