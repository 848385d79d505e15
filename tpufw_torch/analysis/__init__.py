"""tpulint for the port — static analysis of ``tpufw_torch`` (port of
``tpufw.analysis``'s core and python layer).

``python -m tpufw_torch.analysis [paths...]`` runs the domain rules
that apply to torch code (see docs/torch/ANALYSIS.md for the catalog):

- TPU001 hot-loop purity: no host syncs in traced/captured code or
  step loops
- TPU004 env-var registry: TPUFW_* knobs round-trip through
  tpufw_torch.workloads.env and docs/torch/ENV.md
- TPU005 obs-name hygiene: event kinds and metric names match the
  schema and the documented catalog
- TPU009 lock discipline in the threaded classes

Stdlib-only (``ast``); importing this package never imports torch, so
the lint runs in bare CI containers and pre-commit hooks.
"""

from tpufw_torch.analysis.core import (  # noqa: F401
    Checker,
    Finding,
    Project,
    all_checkers,
    load_baseline,
    run_analysis,
    split_by_baseline,
    write_baseline,
)

__all__ = [
    "Checker",
    "Finding",
    "Project",
    "all_checkers",
    "load_baseline",
    "run_analysis",
    "split_by_baseline",
    "write_baseline",
]
