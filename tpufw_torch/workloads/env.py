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


def batch_mesh_from_env():
    """The ``MeshConfig`` of the ``rl`` and ``embed`` workloads from the
    knobs ``tpufw``'s read: ``TPUFW_MESH_DATA`` (1), ``TPUFW_MESH_FSDP``
    (-1: every other device) and ``TPUFW_MESH_TENSOR`` (1). The trainer
    checks it against the gang."""
    from tpufw_torch.mesh import MeshConfig

    return MeshConfig(data=env_int("mesh_data", 1),
                      fsdp=env_int("mesh_fsdp", -1),
                      tensor=env_int("mesh_tensor", 1))


def mesh_from_env(world: int, moe_dispatch: str = "einsum", pipe: int = 1,
                  base=None):
    """The ``MeshConfig`` of ``TPUFW_MESH_{DATA,FSDP,EXPERT,SEQUENCE,
    TENSOR,DCN_DATA}`` over ``base``'s sizes (a YAML run config's mesh;
    default ``tpufw``'s defaults: every device on ``fsdp``)
    with ``pipe`` pipeline stages (the pipeline workload's
    ``TPUFW_PIPE_STAGES``), checked against a ``world``-rank gang, axes in
    ``tpufw``'s order. ``pipe`` with ``sequence`` above 1 raises
    NotImplementedError; axes that do not fit the world raise ``tpufw``'s
    ValueError. The sorted MoE dispatch is
    refused only when the RESOLVED ``expert`` axis is above 1 (``tpufw``
    refuses it for -1 even where -1 is one device)."""
    from tpufw_torch.mesh import MeshConfig, mesh_shape
    from tpufw_torch.mesh.mesh import refuse_pipe_with_sequence

    base = base or MeshConfig()
    cfg = MeshConfig(
        data=env_int("mesh_data", base.data),
        pipe=pipe,
        fsdp=env_int("mesh_fsdp", base.fsdp),
        expert=env_int("mesh_expert", base.expert),
        sequence=env_int("mesh_sequence", base.sequence),
        tensor=env_int("mesh_tensor", base.tensor),
        dcn_data=env_int("mesh_dcn_data", base.dcn_data),
    )
    refuse_pipe_with_sequence(pipe, cfg.sequence)
    expert = cfg.slice_sizes(world)["expert"]
    if moe_dispatch == "sorted" and expert > 1:
        raise ValueError(
            "moe_dispatch='sorted' keeps expert weight stacks whole "
            f"and cannot shard the expert mesh axis (got expert="
            f"{expert}); use the default einsum dispatch for "
            "expert parallelism"
        )
    mesh_shape(cfg, world)
    return cfg
