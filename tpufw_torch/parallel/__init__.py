"""Sequence, pipeline, tensor and expert parallelism (port of
``tpufw.parallel``): the current-mesh registry, the ring's collectives,
the ring, ring-flash and Ulysses attention bodies, the pipe groups of the
pipeline schedules (``parallel.pipeline``, ``pipeline_1f1b``,
``pipeline_zb1``, ``pipeline_interleaved``, imported where used), and
the tensor and expert groups with the Megatron shard math
(``parallel.tensor``)."""

from tpufw_torch.parallel.context import (  # noqa: F401
    current_mesh,
    expert_group,
    model_groups,
    sequence_group,
    set_current_mesh,
    tensor_group,
    use_groups,
    use_mesh,
)
from tpufw_torch.parallel.group import (  # noqa: F401
    ExpertGroup,
    LocalExpertGroup,
    LocalPipeGroup,
    LocalSequenceGroup,
    LocalTensorGroup,
    PipeGroup,
    ProcessExpertGroup,
    ProcessPipeGroup,
    ProcessSequenceGroup,
    ProcessTensorGroup,
    SequenceGroup,
    TensorGroup,
)
from tpufw_torch.parallel.ring import ring_attention  # noqa: F401
from tpufw_torch.parallel.ring_flash import ring_flash_attention  # noqa: F401
from tpufw_torch.parallel.ulysses import ulysses_attention  # noqa: F401
