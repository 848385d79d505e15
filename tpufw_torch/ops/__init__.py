from tpufw_torch.ops.attention import multi_head_attention, xla_attention  # noqa: F401
from tpufw_torch.ops.loss import chunked_cross_entropy  # noqa: F401
from tpufw_torch.ops.norms import rms_norm  # noqa: F401
