"""Process-wide current-mesh registry (port of ``tpufw.parallel.context``).

The models call attention through ``ops.multi_head_attention`` without a
mesh argument; the ``Trainer`` (or the user) registers the active mesh
here and the sequence-parallel backends (``ring``, ``ulysses``) pick it
up. Explicit ``mesh=`` arguments always win.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (its ``sequence``
dimension is the ring) or a ``parallel.group.LocalSequenceGroup``, one
process holding every shard of a ring (the counterpart of ``tpufw``'s
virtual CPU mesh). ``sequence_group`` turns either into the ring's
``SequenceGroup``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from tpufw_torch.mesh.mesh import AXIS_SEQUENCE
from tpufw_torch.parallel.group import (
    LocalSequenceGroup,
    ProcessSequenceGroup,
    SequenceGroup,
)

_current = None


def set_current_mesh(mesh) -> None:
    global _current
    _current = mesh


def current_mesh():
    return _current


@contextlib.contextmanager
def use_mesh(mesh):
    global _current
    prev = _current
    _current = mesh
    try:
        yield mesh
    finally:
        _current = prev


def sequence_group(mesh, axis_name: str = AXIS_SEQUENCE) -> SequenceGroup:
    """The sequence ring of ``mesh``: a ``SequenceGroup`` itself, or a
    ``DeviceMesh``'s ``axis_name`` dimension as a ``ProcessSequenceGroup``
    (its process group, this rank's index and its size; a mesh without
    that dimension is a ring of one shard)."""
    if isinstance(mesh, SequenceGroup):
        return mesh
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        return LocalSequenceGroup(1)
    dim = names.index(axis_name)
    return ProcessSequenceGroup(mesh.get_group(axis_name), mesh.size(dim),
                                mesh.get_local_rank(axis_name))


def partial_sequence_group() -> Optional[ProcessSequenceGroup]:
    """The registered mesh's sequence ring when this process holds one of
    its several shards (the activations are split along the sequence),
    else None."""
    if _current is None:
        return None
    group = sequence_group(_current)
    return None if group.holds_all else group
