from tpufw_torch.configs.presets import (  # noqa: F401
    BENCH_CONFIG_NAME,
    bench_model_config,
    deepseek_mla_serve_slice,
    deepseek_mla_train_slice,
    gemma2_9b_serve_slice,
    gemma2_9b_train_slice,
    llama3_8b_serve_slice,
    llama3_8b_train_slice,
    mixtral_8x7b_serve_slice,
    mixtral_8x7b_train_slice,
    resolve_model_preset,
)
