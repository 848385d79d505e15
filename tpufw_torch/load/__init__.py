"""Load observatory (a copy of ``tpufw.load``): deterministic traffic
replay, capacity-frontier sweeps, and the closed-loop scaling executor.
Torch-free, like the router it drives — importable on a laptop, a CI
runner, or the card's host without pulling in the model stack."""

from tpufw_torch.load.genload import (  # noqa: F401
    LOAD_TRACE_REQUIRED,
    MixConfig,
    Offered,
    ReplayClient,
    TraceWriter,
    parse_tenant_weights,
    read_trace,
    schedule,
    schedule_digest,
    validate_trace_record,
)
from tpufw_torch.load.sweep import (  # noqa: F401
    SweepConfig,
    detect_knee,
    rung_stats,
    run_sweep,
)
from tpufw_torch.load.executor import GangExecutor  # noqa: F401
