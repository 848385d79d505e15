"""MFU autotuner (port of ``tpufw.tune``): a measured search over the
train-step knobs.

- ``space``  — candidates, validity rules, memory pre-pruning
- ``runner`` — the budgeted measurement loop and the trainers' entry
- ``cache``  — winners kept per (machine, model, batch/seq, mesh)

Turned on by ``TrainerConfig.autotune`` ("off" | "cached" | "search") or
``TPUFW_AUTOTUNE`` in the workloads.
"""

from tpufw_torch.tune.space import (  # noqa: F401
    Candidate,
    SearchSpace,
    enumerate_candidates,
)
from tpufw_torch.tune.runner import (  # noqa: F401
    TuneResult,
    Trial,
    apply_autotune,
    make_measure_fn,
    search,
)
from tpufw_torch.tune import cache  # noqa: F401
