"""Replica discovery for the disaggregated-serving router: where do
the prefill and decode pools live? (A copy of
``tpufw.cluster.discovery``.)

Resolution order (first match wins), mirroring ``tpufw.cluster.bootstrap``'s shape:

1. Explicit ``TPUFW_ROUTER_PREFILL`` / ``TPUFW_ROUTER_DECODE`` —
   comma-separated ``host:port`` lists. Escape hatch for tests,
   bare-metal, and the loopback CI smoke.
2. JobSet DNS: the disagg manifest (deploy/manifests/13-*) runs the
   prefill and decode pools as replicated jobs of ONE JobSet with
   ``enableDNSHostnames``, so replica ``i`` of job ``j`` is reachable
   at ``<jobset>-<j>-<i>-0.<jobset>`` (the convention
   ``tpufw.cluster.bootstrap`` uses for the coordinator). ``TPUFW_ROUTER_PREFILL_REPLICAS`` /
   ``TPUFW_ROUTER_DECODE_REPLICAS`` give the counts; the replicated
   job names default to ``prefill`` / ``decode``.

Ports default to the replicas' ``TPUFW_SERVE_PEER_PORT`` contract.
"""

from __future__ import annotations

# tpulint: disable-file=TPU004 — like bootstrap.py, this module reads
# through an injectable ``env: Mapping`` (the router's tests pass dicts,
# and a JobSet's variables sit beside the TPUFW_* ones), which the typed
# helpers over os.environ cannot take. Its knobs are cataloged in
# docs/torch/ENV.md.

import os
from typing import List, Mapping, Optional, Tuple

DEFAULT_PEER_PORT = 8477  # = tpufw_torch.serve.roles.DEFAULT_PEER_PORT

Addr = Tuple[str, int]


def _parse_addr_list(spec: str, default_port: int) -> List[Addr]:
    out: List[Addr] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if sep:
            out.append((host, int(port)))
        else:
            out.append((part, default_port))
    return out


def _jobset_addrs(
    env: Mapping[str, str], job: str, count: int, port: int
) -> List[Addr]:
    jobset = env["JOBSET_NAME"]
    return [
        (f"{jobset}-{job}-{i}-0.{jobset}", port) for i in range(count)
    ]


def discover_replicas(
    env: Optional[Mapping[str, str]] = None,
) -> Tuple[List[Addr], List[Addr]]:
    """(prefill_addrs, decode_addrs) for the router's pools. Raises
    ValueError when neither the explicit lists nor a countable JobSet
    environment is present — a router with zero replicas must fail at
    startup, not 503 forever."""
    env = os.environ if env is None else env
    port = int(env.get("TPUFW_SERVE_PEER_PORT", DEFAULT_PEER_PORT))

    explicit_p = env.get("TPUFW_ROUTER_PREFILL", "")
    explicit_d = env.get("TPUFW_ROUTER_DECODE", "")
    if explicit_p or explicit_d:
        prefill = _parse_addr_list(explicit_p, port)
        decode = _parse_addr_list(explicit_d, port)
        if not prefill or not decode:
            raise ValueError(
                "TPUFW_ROUTER_PREFILL / TPUFW_ROUTER_DECODE must BOTH "
                "name at least one host:port (got "
                f"{len(prefill)} prefill, {len(decode)} decode)"
            )
        return prefill, decode

    if "JOBSET_NAME" in env:
        n_prefill = int(env.get("TPUFW_ROUTER_PREFILL_REPLICAS", "0"))
        n_decode = int(env.get("TPUFW_ROUTER_DECODE_REPLICAS", "0"))
        if n_prefill <= 0 or n_decode <= 0:
            raise ValueError(
                "JobSet environment detected (JOBSET_NAME set) but "
                "TPUFW_ROUTER_PREFILL_REPLICAS / "
                "TPUFW_ROUTER_DECODE_REPLICAS are missing — the "
                "deploy/ disagg manifest sets them to the replicated "
                "jobs' replica counts"
            )
        return (
            _jobset_addrs(env, "prefill", n_prefill, port),
            _jobset_addrs(env, "decode", n_decode, port),
        )

    raise ValueError(
        "no replica discovery source: set TPUFW_ROUTER_PREFILL + "
        "TPUFW_ROUTER_DECODE (host:port lists) or run inside the "
        "disagg JobSet"
    )
