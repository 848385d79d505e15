"""Disaggregated serving (port of ``tpufw.serve``): prefill/decode replica
roles, the TPFB page bundle that migrates KV between them, the framed
transport, and the front-door router that load-balances sessions across
replica pools.

``TPUFW_SERVE_ROLE`` selects which role a ``tpufw_torch.workloads.serve``
process runs (``tpufw_torch.serve.roles.main_role``). Nothing here imports
torch at import time, so a router process (``tpufw_torch.serve.router``)
needs no CUDA: the engines import it when they build their pools."""

from tpufw_torch.serve.bundle import (  # noqa: F401
    BundleError,
    decode_bundle,
    encode_bundle,
)
from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine  # noqa: F401
from tpufw_torch.serve.router import RouterPolicy  # noqa: F401
from tpufw_torch.serve.transport import (  # noqa: F401
    LoopbackTransport,
    TcpTransport,
)
