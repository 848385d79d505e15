"""Model families of the port: Llama-3 (with Mistral and Qwen-2 on the
same trunk), Mixtral (sparse MoE on the Llama trunk), Gemma-2 and
DeepSeek-V2 (MLA, with a dense or MoE FFN), with LoRA adapters
(``models.lora``) on the first three; and the vision classifiers, ViT
and ResNet-50."""

from tpufw_torch.models.deepseek import (  # noqa: F401
    DEEPSEEK_CONFIGS,
    Deepseek,
    DeepseekConfig,
    LatentCache,
    PagedLatentCache,
)
from tpufw_torch.models.gemma import (  # noqa: F401
    GEMMA_CONFIGS,
    Gemma,
    GemmaConfig,
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
from tpufw_torch.models.lora import has_lora, merge_lora  # noqa: F401
from tpufw_torch.models.mixtral import (  # noqa: F401
    MIXTRAL_CONFIGS,
    Mixtral,
    MixtralConfig,
    MoEMLP,
)
from tpufw_torch.models.resnet import ResNet, ResNetConfig, resnet50  # noqa: F401
from tpufw_torch.models.vit import VIT_CONFIGS, ViT, ViTConfig  # noqa: F401

# Every named preset of the four families.
PRESETS = {**LLAMA_CONFIGS, **MIXTRAL_CONFIGS, **GEMMA_CONFIGS,
           **DEEPSEEK_CONFIGS}


def model_for_config(cfg, device=None, seed: int = 0) -> Llama:
    """The model class of ``cfg`` (``Mixtral`` for a ``MixtralConfig``,
    ``Gemma`` for a ``GemmaConfig``, ``Deepseek`` for a ``DeepseekConfig``,
    else ``Llama``) with weights drawn from ``seed`` on ``device``."""
    if isinstance(cfg, MixtralConfig):
        cls = Mixtral
    elif isinstance(cfg, GemmaConfig):
        cls = Gemma
    elif isinstance(cfg, DeepseekConfig):
        cls = Deepseek
    else:
        cls = Llama
    return cls(cfg, device=device, seed=seed)
