"""Sequence parallelism (port of ``tpufw.parallel``): the current-mesh
registry, the ring's collectives, and the ring, ring-flash and Ulysses
attention bodies."""

from tpufw_torch.parallel.context import (  # noqa: F401
    current_mesh,
    sequence_group,
    set_current_mesh,
    use_mesh,
)
from tpufw_torch.parallel.group import (  # noqa: F401
    LocalSequenceGroup,
    ProcessSequenceGroup,
    SequenceGroup,
)
from tpufw_torch.parallel.ring import ring_attention  # noqa: F401
from tpufw_torch.parallel.ring_flash import ring_flash_attention  # noqa: F401
from tpufw_torch.parallel.ulysses import ulysses_attention  # noqa: F401
