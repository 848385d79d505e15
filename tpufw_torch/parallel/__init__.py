"""Sequence and pipeline parallelism (port of ``tpufw.parallel``): the
current-mesh registry, the ring's collectives, the ring, ring-flash and
Ulysses attention bodies, and the pipe groups of the pipeline schedules
(``parallel.pipeline``, ``pipeline_1f1b``, ``pipeline_zb1``,
``pipeline_interleaved``, imported where used)."""

from tpufw_torch.parallel.context import (  # noqa: F401
    current_mesh,
    sequence_group,
    set_current_mesh,
    use_mesh,
)
from tpufw_torch.parallel.group import (  # noqa: F401
    LocalPipeGroup,
    LocalSequenceGroup,
    PipeGroup,
    ProcessPipeGroup,
    ProcessSequenceGroup,
    SequenceGroup,
)
from tpufw_torch.parallel.ring import ring_attention  # noqa: F401
from tpufw_torch.parallel.ring_flash import ring_flash_attention  # noqa: F401
from tpufw_torch.parallel.ulysses import ulysses_attention  # noqa: F401
