from tpufw_torch.train.data import (  # noqa: F401
    pack_documents,
    synthetic_batches,
    synthetic_packed_batches,
)
from tpufw_torch.train.metrics import Meter, StepMetrics  # noqa: F401
from tpufw_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
