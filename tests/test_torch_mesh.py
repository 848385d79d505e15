"""The port's mesh sizing against ``tpufw.mesh`` (``tests/test_mesh.py``'s
cases) on its 8 virtual devices: the same axis sizes, the same errors
word for word, and ``rank_grid`` laying ranks out as ``build_mesh`` lays
out device ids, with and without ``dcn_data``. Then what the port builds
of it: the (``data``, ``fsdp``) ``DeviceMesh`` of a gloo group, and the
refusal of the axes a later slice brings."""

import numpy as np
import pytest

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
    ({}, 4, {"data": 1, "fsdp": 4}),
    ({"data": 2}, 4, {"data": 2, "fsdp": 2}),
    ({"dcn_data": 2, "data": 2, "fsdp": 1}, 4, {"data": 4, "fsdp": 1}),
])
def test_mesh_shape_is_data_by_fsdp(kw, world, shape):
    assert mesh_shape(MeshConfig(**kw), world) == shape


@pytest.mark.parametrize("axis,item", [("sequence", "12b"),
                                       ("tensor", "12e"),
                                       ("expert", "12e"),
                                       ("pipe", "12c")])
def test_later_axes_refused(axis, item):
    with pytest.raises(NotImplementedError, match=rf"item {item}\)$"):
        mesh_shape(MeshConfig(**{axis: 2, "fsdp": 2}), 4)
    # A fill that resolves to one device is no such axis.
    assert mesh_shape(MeshConfig(**{axis: -1, "fsdp": 4}), 4) == {
        "data": 1, "fsdp": 4}


def test_build_mesh_on_a_gloo_group():
    import torch.distributed as dist

    from tpufw_torch.cluster import init_process_group

    init_process_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        mesh = build_mesh(MeshConfig(), 1, "cpu")
        assert mesh.mesh_dim_names == ("data", "fsdp")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()
