"""The port's mesh sizing against ``tpufw.mesh`` (``tests/test_mesh.py``'s
cases) on its 8 virtual devices: the same axis sizes, the same errors
word for word, and ``rank_grid`` laying ranks out as ``build_mesh`` lays
out device ids, with and without ``dcn_data``. Then what the port builds
of it: the (``data``, ``fsdp``, ``sequence``) ``DeviceMesh`` of a gloo
group, the ``pipe`` dimension (and its refusal beside ``sequence``), the
``expert`` and ``tensor`` dimensions (refused beside ``sequence``), and
the global
token order a MoE layer routes a sequence-split gang's tokens in."""

import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_gang import free_port
from tpufw.mesh import MESH_AXES as J_AXES
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.mesh import build_mesh as j_build_mesh
from tpufw_torch.mesh import (
    MESH_AXES,
    MeshConfig,
    build_mesh,
    mesh_shape,
    rank_grid,
)

SHAPES = [
    # BASELINE config 3: single-host 4-chip llama (fsdp x tensor).
    ({"fsdp": 2, "tensor": 4}, {"fsdp": 2, "tensor": 4}),
    # Config 4's shape class: data x fsdp multi-host.
    ({"data": 2, "fsdp": 4}, {"data": 2, "fsdp": 4}),
    # Config 5's: expert parallel.
    ({"fsdp": 2, "expert": 4}, {"fsdp": 2, "expert": 4}),
    # Sequence parallel for ring attention.
    ({"fsdp": 1, "sequence": 8}, {"sequence": 8}),
]


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def test_default_mesh_fills_fsdp(devices8):
    assert MESH_AXES == J_AXES
    sizes = MeshConfig().sizes(8)
    assert sizes["fsdp"] == 8 and sizes["data"] == 1
    np.testing.assert_array_equal(rank_grid(MeshConfig(), 8),
                                  _ids(j_build_mesh(JMeshConfig())))


@pytest.mark.parametrize("kw,expect", SHAPES)
def test_mesh_shapes(devices8, kw, expect):
    sizes = MeshConfig(**kw).sizes(8)
    for axis, size in expect.items():
        assert sizes[axis] == size
    assert int(np.prod(list(sizes.values()))) == 8
    mesh = j_build_mesh(JMeshConfig(**kw))
    assert sizes == dict(mesh.shape)
    np.testing.assert_array_equal(rank_grid(MeshConfig(**kw), 8), _ids(mesh))
    assert MeshConfig(**kw).model_parallel_size(8) == \
        JMeshConfig(**kw).model_parallel_size(8)


@pytest.mark.parametrize("kw,n", [({"fsdp": -1, "tensor": 3}, 8),
                                  ({"fsdp": -1, "data": -1}, 8),
                                  ({"fsdp": 4, "tensor": 4}, 8),
                                  ({"data": 0}, 8),
                                  ({"data": 2, "fsdp": 1}, 1)])
def test_fill_divisibility_errors_are_tpufws(kw, n):
    with pytest.raises(ValueError) as want:
        JMeshConfig(**kw).sizes(n)
    with pytest.raises(ValueError) as got:
        MeshConfig(**kw).sizes(n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{"dcn_data": 2, "data": 1, "fsdp": 2,
                                 "tensor": 2},
                                {"dcn_data": 2, "fsdp": -1},
                                {"dcn_data": 4, "data": 2, "fsdp": 1}])
def test_dcn_multislice_grid(devices8, kw):
    """DCN is the slowest-varying part of ``data``: slice 0 is the first
    ranks, as ``tpufw`` emulates a multi-slice mesh on CPU devices."""
    mesh = j_build_mesh(JMeshConfig(**kw))
    grid = rank_grid(MeshConfig(**kw), 8)
    np.testing.assert_array_equal(grid, _ids(mesh))
    assert grid.shape[0] == mesh.shape["data"]


def test_dcn_indivisible_raises(devices8):
    with pytest.raises(ValueError, match="DCN") as want:
        j_build_mesh(JMeshConfig(dcn_data=3))
    with pytest.raises(ValueError, match="DCN") as got:
        rank_grid(MeshConfig(dcn_data=3), 8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,world,shape", [
    ({}, 4, {"data": 1, "fsdp": 4, "sequence": 1}),
    ({"data": 2}, 4, {"data": 2, "fsdp": 2, "sequence": 1}),
    ({"dcn_data": 2, "data": 2, "fsdp": 1}, 4,
     {"data": 4, "fsdp": 1, "sequence": 1}),
    ({"fsdp": 2, "sequence": 2}, 4, {"data": 1, "fsdp": 2, "sequence": 2}),
])
def test_mesh_shape_is_data_by_fsdp(kw, world, shape):
    assert mesh_shape(MeshConfig(**kw), world) == shape


@pytest.mark.parametrize("axis,item", [("tensor", "12e"),
                                       ("expert", "12e")])
def test_later_axes_refused(axis, item):
    """Item 12e (``item``) made ``tensor`` and ``expert`` mesh dimensions,
    in ``tpufw``'s axis order; since item 12g they sit beside a
    ``sequence`` axis above 1 too, still in that order (no longer
    refused)."""
    assert item == "12e"
    assert mesh_shape(MeshConfig(**{axis: 2, "fsdp": 2}), 4) == dict(
        {"data": 1, "fsdp": 2}, **({"expert": 2, "sequence": 1}
                                   if axis == "expert" else
                                   {"sequence": 1, "tensor": 2}))
    beside = mesh_shape(MeshConfig(**{axis: 2, "fsdp": 1, "sequence": 2}), 4)
    assert list(beside.items()) == [("data", 1), ("fsdp", 1)] + (
        [("expert", 2), ("sequence", 2)] if axis == "expert" else
        [("sequence", 2), ("tensor", 2)])
    # A fill that resolves to one device is no such axis.
    assert mesh_shape(MeshConfig(**{axis: -1, "fsdp": 4}), 4) == {
        "data": 1, "fsdp": 4, "sequence": 1}


@pytest.mark.parametrize("kw,world,shape", [
    ({"pipe": 2}, 4, {"data": 1, "pipe": 2, "fsdp": 2, "sequence": 1}),
    ({"data": 2, "pipe": 2, "fsdp": 1}, 4,
     {"data": 2, "pipe": 2, "fsdp": 1, "sequence": 1}),
    ({"pipe": 4}, 4, {"data": 1, "pipe": 4, "fsdp": 1, "sequence": 1}),
    ({"pipe": -1, "fsdp": 4}, 4, {"data": 1, "fsdp": 4, "sequence": 1}),
    ({"pipe": 2, "fsdp": 1, "tensor": 2}, 4,
     {"data": 1, "pipe": 2, "fsdp": 1, "sequence": 1, "tensor": 2}),
    ({"pipe": 2, "fsdp": 1, "expert": 2, "tensor": 2}, 8,
     {"data": 1, "pipe": 2, "fsdp": 1, "expert": 2, "sequence": 1,
      "tensor": 2}),
])
def test_pipe_axis_is_a_dimension(devices8, kw, world, shape):
    """``pipe`` above 1 is a mesh dimension in ``tpufw``'s axis order (a
    fill that resolves to one device is none), beside ``tensor`` and
    ``expert`` too, and its ranks are laid out as ``tpufw`` lays out its
    devices."""
    import jax

    assert mesh_shape(MeshConfig(**kw), world) == shape
    grid = rank_grid(MeshConfig(**kw), world).reshape(tuple(shape.values()))
    jgrid = _ids(j_build_mesh(JMeshConfig(**kw), devices=jax.devices()[:world]))
    np.testing.assert_array_equal(grid, jgrid.reshape(grid.shape))


def test_pipe_with_sequence_refused():
    """``tpufw``'s pipeline needs ``sequence`` 1; so does the port's."""
    with pytest.raises(NotImplementedError, match="sequence has size 2"):
        mesh_shape(MeshConfig(pipe=2, sequence=2, fsdp=1), 4)


def test_build_mesh_on_a_gloo_group():
    import torch.distributed as dist

    from tpufw_torch.cluster import init_process_group

    init_process_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        mesh = build_mesh(MeshConfig(), 1, "cpu")
        assert mesh.mesh_dim_names == ("data", "fsdp", "sequence")
        assert tuple(mesh.shape) == (1, 1, 1)
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [{"data": 2, "fsdp": 2, "sequence": 2},
                                {"data": 2, "fsdp": 1, "sequence": 4},
                                {"dcn_data": 2, "fsdp": 2, "sequence": 2}])
def test_routing_order_is_the_global_row_major_order(kw):
    """Each rank of a (data, fsdp, sequence) grid holds the rows of its
    batch shard (its data, fsdp coordinate) and the positions of its
    sequence index; ``routing_order`` puts their concatenation in rank
    order back in the global batch's row-major [B, T] order, and this
    rank's tokens are where ``gather_routing`` says."""
    import torch

    from tpufw_torch.ops.moe import routing_order

    world, rows, length = 8, 3, 5
    cfg = MeshConfig(**kw)
    grid = rank_grid(cfg, world)
    sizes = dict(zip(MESH_AXES, grid.shape))
    n_shards = sizes["data"] * sizes["fsdp"]
    seq = sizes["sequence"]
    tokens = torch.arange(n_shards * rows * seq * length).reshape(
        n_shards * rows, seq * length)
    parts = [None] * world
    for coord in np.ndindex(*grid.shape):
        c = dict(zip(MESH_AXES, coord))
        shard = c["data"] * sizes["fsdp"] + c["fsdp"]
        s = c["sequence"]
        parts[grid[coord]] = tokens[shard * rows:(shard + 1) * rows,
                                    s * length:(s + 1) * length].reshape(-1)
    gathered = torch.cat(parts)
    order = routing_order(world, seq, rows, length)
    assert torch.equal(gathered[order], tokens.reshape(-1))


def test_sequence_split_of_a_row():
    """Under a ring of 2 ranks, rank 1 trains the second half of every
    shifted row at its global positions; a length the ring does not
    divide raises, naming both numbers."""
    import torch

    from tpufw_torch.parallel import ProcessSequenceGroup, use_mesh
    from tpufw_torch.train.trainer import sequence_positions, shift_and_mask

    tokens = torch.arange(2 * 65).reshape(2, 65)
    seg = torch.ones(2, 65, dtype=torch.int32)
    with use_mesh(ProcessSequenceGroup(None, 2, 1)):
        inputs, targets, seg_in, mask = shift_and_mask(
            {"tokens": tokens, "segment_ids": seg})
        positions = sequence_positions(inputs)
        with pytest.raises(ValueError, match="size 2 must divide the 63 "):
            shift_and_mask({"tokens": tokens[:, :64]})
    assert torch.equal(inputs, tokens[:, 32:64])
    assert torch.equal(targets, tokens[:, 33:65])
    assert seg_in.shape == mask.shape == (2, 32)
    assert torch.equal(positions, torch.arange(32, 64).expand(2, 32))
