from tpufw_torch.train.checkpoint import CheckpointManager  # noqa: F401
from tpufw_torch.train.contrastive import (  # noqa: F401
    ContrastiveConfig,
    EmbeddingTrainer,
    contrastive_train_step,
    info_nce_loss,
)
from tpufw_torch.train.data import (  # noqa: F401
    pack_documents,
    synthetic_batches,
    synthetic_packed_batches,
)
from tpufw_torch.train.distill import DistillConfig, DistillTrainer  # noqa: F401
from tpufw_torch.train.dpo import (  # noqa: F401
    DPOConfig,
    DPOTrainer,
    dpo_batches,
    dpo_train_step,
)
from tpufw_torch.train.grpo import (  # noqa: F401
    GRPOConfig,
    GRPOTrainer,
    group_advantages,
    grpo_train_step,
)
from tpufw_torch.train.metrics import Meter, StepMetrics  # noqa: F401
from tpufw_torch.train.pipeline_trainer import PipelineTrainer  # noqa: F401
from tpufw_torch.train.native_data import (  # noqa: F401
    TokenCorpus,
    write_token_corpus,
)
from tpufw_torch.train.prefetch import prefetch_to_device  # noqa: F401
from tpufw_torch.train.sft import sft_batches  # noqa: F401
from tpufw_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
from tpufw_torch.train.vision import (  # noqa: F401
    VisionTrainer,
    VisionTrainerConfig,
    synthetic_images,
)
