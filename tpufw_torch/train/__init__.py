from tpufw_torch.train.checkpoint import CheckpointManager  # noqa: F401
from tpufw_torch.train.data import (  # noqa: F401
    pack_documents,
    synthetic_batches,
    synthetic_packed_batches,
)
from tpufw_torch.train.metrics import Meter, StepMetrics  # noqa: F401
from tpufw_torch.train.native_data import (  # noqa: F401
    TokenCorpus,
    write_token_corpus,
)
from tpufw_torch.train.prefetch import prefetch_to_device  # noqa: F401
from tpufw_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
from tpufw_torch.train.vision import (  # noqa: F401
    VisionTrainer,
    VisionTrainerConfig,
    synthetic_images,
)
