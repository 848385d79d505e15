"""The named device mesh of a training gang (port of ``tpufw.mesh.mesh``).

``tpufw`` lays its chips out on a six-axis ``jax.sharding.Mesh`` and lets
XLA insert the collectives. The port keeps the same axis names and the
same sizing rules (``MeshConfig``, one axis may be -1 to fill), and lays
the gang's RANKS out as ``tpufw`` lays out its devices (``rank_grid``).
One rank is one GPU.

``build_mesh`` turns that grid into a ``torch.distributed`` ``DeviceMesh``
with the dimensions the port shards over: ``data`` (of size
``dcn_data * data``: plain replicas), ``pipe`` when it is above 1 (the
layer stack split into stages, ``parallel.pipeline``), ``fsdp``
(parameters, gradients and optimizer state sharded, as ZeRO-3) and
``sequence`` (activations split along the sequence; ring or Ulysses
attention), in ``tpufw``'s axis order. The trainers shard the parameters
over ``fsdp`` and ``sequence`` together and replicate them over ``data``
(``train.sharding``); the pipeline trainer gives each ``pipe`` rank its
stage and feeds ``data`` and ``fsdp`` as batch shards. ``pipe`` composes
with ``data``, ``fsdp``, ``tensor`` and ``expert`` (``sequence`` must be
1, as in ``tpufw/parallel/pipeline.py``); ``sequence`` composes with
every other axis.

``expert`` and ``tensor`` (dimensions when above 1) split the model's
weights as ``tpufw``'s ``logical_axis_rules`` map them (ported here as a
table): attention heads, MLP widths and the vocabulary over ``tensor``
(Megatron), a MoE layer's experts over ``expert``. Their ranks share the
rows of one batch shard (``batch`` maps to ``data`` and ``fsdp`` only).
The ``Trainer`` (beside a ``sequence`` ring too: each tensor shard's
heads run their own ring), its post-training subclasses, the
``PipelineTrainer`` (inside each stage) and the ``VisionTrainer``
(``tensor``) train over them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

AXIS_DATA = "data"
AXIS_PIPE = "pipe"
AXIS_FSDP = "fsdp"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"
AXIS_EXPERT = "expert"

# Leftmost axes vary slowest across ranks: ``data`` spans hosts, ``tensor``
# (rightmost) stays inside a host's fastest links, as in ``tpufw``.
MESH_AXES: tuple[str, ...] = (
    AXIS_DATA,
    AXIS_PIPE,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)

# The model-parallel axes: the ones a parameter is split over.
MODEL_AXES = (AXIS_EXPERT, AXIS_TENSOR)


def logical_axis_rules() -> tuple[tuple[str, tuple[str, ...] | None], ...]:
    """(logical axis -> mesh axes) rules, ``tpufw``'s default table:
    ``batch`` spans the data-like axes; parameters shard their largest
    dim over ``fsdp`` (ZeRO-3) and their model-parallel dim over
    ``tensor``; ``expert`` maps experts onto the expert axis; activations'
    sequence dim maps onto ``sequence``. ``parallel.tensor.split_specs``
    reads the ``expert`` and ``tensor`` entries."""
    return (
        ("batch", (AXIS_DATA, AXIS_FSDP)),
        ("act_seq", (AXIS_SEQUENCE,)),
        ("act_embed", None),
        ("act_heads", (AXIS_TENSOR,)),
        ("act_mlp", (AXIS_TENSOR,)),
        ("act_vocab", (AXIS_TENSOR,)),
        ("embed", (AXIS_FSDP,)),
        ("mlp", (AXIS_TENSOR,)),
        ("heads", (AXIS_TENSOR,)),
        ("q_heads", (AXIS_TENSOR,)),
        ("kv_heads", (AXIS_TENSOR,)),
        ("head_dim", None),
        ("lora", None),
        ("kv_latent", None),
        ("q_latent", None),
        ("vocab", (AXIS_TENSOR,)),
        ("expert", (AXIS_EXPERT,)),
        ("expert_mlp", (AXIS_TENSOR,)),
        ("norm", None),
        ("conv_h", None),
        ("conv_w", None),
        ("conv_in", None),
        ("conv_out", (AXIS_FSDP,)),
    )


def mesh_axes_of(logical: tuple) -> list[tuple[str, ...]]:
    """The mesh axes each logical axis of ``logical`` (a parameter's
    spec; None = replicated) shards over, by ``logical_axis_rules``."""
    rules = dict(logical_axis_rules())
    return [tuple(rules.get(a) or ()) if a is not None else ()
            for a in logical]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of the six named mesh axes. -1 on at most one axis = "fill".

    ``dcn_data`` > 1 declares a multi-slice deployment: that many groups
    of ranks joined over the slow network, with pure data parallelism
    across them. The other sizes then describe ONE group; the built
    mesh's ``data`` dimension has size ``dcn_data * data`` with the slow
    network as its slowest-varying part.
    """

    data: int = 1
    pipe: int = 1
    fsdp: int = -1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1
    dcn_data: int = 1

    def sizes(self, n_devices: int) -> dict[str, int]:
        """Per-slice axis sizes (n_devices = devices in one slice)."""
        raw = {
            AXIS_DATA: self.data,
            AXIS_PIPE: self.pipe,
            AXIS_FSDP: self.fsdp,
            AXIS_EXPERT: self.expert,
            AXIS_SEQUENCE: self.sequence,
            AXIS_TENSOR: self.tensor,
        }
        bad = [k for k, v in raw.items() if v != -1 and v < 1]
        if bad:
            raise ValueError(f"axis sizes must be >=1 or -1 (fill), got {raw}")
        fills = [k for k, v in raw.items() if v == -1]
        if len(fills) > 1:
            raise ValueError(f"at most one axis may be -1, got {fills}")
        fixed = math.prod(v for v in raw.values() if v != -1)
        if fills:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {raw}"
                )
            raw[fills[0]] = n_devices // fixed
            fixed = n_devices
        if fixed != n_devices:
            raise ValueError(
                f"mesh {raw} needs {fixed} devices, have {n_devices}"
            )
        return raw

    def model_parallel_size(self, n_devices: int) -> int:
        """Devices holding one replica's model shards (excl. data/fsdp)."""
        sizes = self.sizes(n_devices)
        return (
            sizes[AXIS_TENSOR]
            * sizes[AXIS_SEQUENCE]
            * sizes[AXIS_EXPERT]
            * sizes[AXIS_PIPE]
        )

    def slice_sizes(self, world: int) -> dict[str, int]:
        """``sizes`` of one DCN slice of a ``world``-rank gang, with
        ``tpufw``'s error when the ranks do not divide into the slices."""
        if self.dcn_data > 1 and world % self.dcn_data:
            raise ValueError(
                f"{world} devices not divisible into "
                f"{self.dcn_data} DCN slices"
            )
        return self.sizes(world // max(self.dcn_data, 1))


def rank_grid(config: MeshConfig | None, world: int) -> np.ndarray:
    """The gang's ranks as an array over ``MESH_AXES`` (the ``data``
    dimension ``dcn_data`` times its per-slice size), laid out as
    ``tpufw``'s ``build_mesh`` lays out devices that are not TPUs: rank
    order reshaped, so the DCN slices are the slowest-varying part."""
    config = config or MeshConfig()
    sizes = config.slice_sizes(world)
    shape = tuple(sizes[a] * (config.dcn_data if a == AXIS_DATA else 1)
                  for a in MESH_AXES)
    return np.arange(world).reshape(shape)


def refuse_pipe_with_sequence(pipe: int, sequence: int) -> None:
    """NotImplementedError for a ``pipe`` axis above 1 beside a
    ``sequence`` one above 1 (``tpufw``'s pipeline needs sequence 1)."""
    if pipe > 1 and sequence > 1:
        raise NotImplementedError(
            "pipeline parallelism composes with data and fsdp only; mesh "
            f"axis sequence has size {sequence} (it must be 1 under "
            f"pipe={pipe})"
        )


def mesh_shape(config: MeshConfig | None, world: int) -> dict[str, int]:
    """The dimensions of ``build_mesh`` for a ``world``-rank gang, in
    ``tpufw``'s axis order: {"data": dcn_data * data, ["pipe": pipe,]
    "fsdp": fsdp, ["expert": expert,] "sequence": sequence, ["tensor":
    tensor]}, the bracketed ones only when above 1. Raises
    NotImplementedError for ``pipe`` with ``sequence`` above 1."""
    config = config or MeshConfig()
    sizes = config.slice_sizes(world)
    refuse_pipe_with_sequence(sizes[AXIS_PIPE], sizes[AXIS_SEQUENCE])
    shape = {AXIS_DATA: sizes[AXIS_DATA] * config.dcn_data}
    for axis in MESH_AXES[1:]:
        if axis in (AXIS_FSDP, AXIS_SEQUENCE) or sizes[axis] > 1:
            shape[axis] = sizes[axis]
    return shape


def build_mesh(config: MeshConfig | None, world: int, device_type: str):
    """The ``DeviceMesh`` (dims ``data``, ``pipe``, ``expert`` and
    ``tensor`` when above 1, ``fsdp``, ``sequence``: ``mesh_shape``) of
    the initialized process group's ``world`` ranks over ``rank_grid``.
    ``device_type`` is ``cuda`` (NCCL) or ``cpu`` (gloo)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = mesh_shape(config, world)
    grid = rank_grid(config, world).reshape(tuple(shape.values()))
    return DeviceMesh(device_type, grid.tolist(),
                      mesh_dim_names=tuple(shape))
