from tpufw_torch.models.llama import (  # noqa: F401
    LLAMA_CONFIGS,
    KVCache,
    Llama,
    LlamaConfig,
    QuantProjection,
    RopeScaling,
)
