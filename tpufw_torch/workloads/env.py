"""TPUFW_* environment configuration helpers (manifest -> env -> dataclass).

The same knob names as ``tpufw.workloads.env``, kept as the port's own copy
so the port never imports the JAX package."""

from __future__ import annotations

import os


def _get(name: str):
    return os.environ.get(f"TPUFW_{name.upper()}")


def env_str(name: str, default: str) -> str:
    v = _get(name)
    return default if v is None else v


def env_int(name: str, default: int) -> int:
    v = _get(name)
    return default if v is None else int(v)


def env_opt_int(name: str, default: "int | None" = None) -> "int | None":
    """Optional int knob where None means "feature off" (e.g.
    TPUFW_METRICS_PORT). Unset -> default; set to the empty string ->
    None (a manifest's way to explicitly disable an inherited value)."""
    v = _get(name)
    if v is None:
        return default
    if v.strip() == "":
        return None
    return int(v)


def env_opt_str(name: str, default: "str | None" = None) -> "str | None":
    """Optional string knob where None means "feature off" (e.g.
    TPUFW_TELEMETRY_DIR). Unset -> default; set to the empty string ->
    None (a manifest's way to explicitly disable an inherited value)."""
    v = _get(name)
    if v is None:
        return default
    if v.strip() == "":
        return None
    return v


def env_float(name: str, default: float) -> float:
    v = _get(name)
    return default if v is None else float(v)


def env_bool(name: str, default: bool) -> bool:
    v = _get(name)
    if v is None:
        return default
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"TPUFW_{name.upper()}={v!r} is not a boolean")


def refuse_unported(knob: str, what: str, item: str) -> None:
    """Raise for a ``tpufw`` knob whose feature the port lacks, naming
    the ROADMAP.md Queue 1 item that brings it."""
    raise NotImplementedError(
        f"TPUFW_{knob.upper()}: {what} is not ported to tpufw_torch yet "
        f"(ROADMAP.md Queue 1 item {item})"
    )


_MESH_AXES = ("data", "fsdp", "expert", "sequence", "tensor", "dcn_data")


def refuse_mesh() -> None:
    """Raise for any ``TPUFW_MESH_*`` axis above 1: the port runs on one
    GPU until its multi-GPU layer (ROADMAP.md Queue 1 item 12)."""
    for axis in _MESH_AXES:
        if env_int(f"mesh_{axis}", 1) > 1:
            refuse_unported(f"mesh_{axis}", "a multi-GPU mesh", "12")
