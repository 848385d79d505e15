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

Beside the ring, the registry holds the model-parallel groups the model
code splits its weights over: the current ``TensorGroup`` (Megatron
attention heads, MLP width and vocabulary) and ``ExpertGroup`` (a MoE
layer's experts), one shard each (``LocalTensorGroup(1)``) unless a
trainer registers its gang's (``model_groups``) or one process's several
(``use_groups``). The two compose: the model calls attention once per
held tensor shard, with that shard's heads, and each call runs the ring
(a gang's ``sequence`` group holds the ranks of one data, fsdp, expert
and tensor coordinate; a ``LocalSequenceGroup`` every shard of the ring
for each tensor shard in turn).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from tpufw_torch.mesh.mesh import AXIS_EXPERT, AXIS_SEQUENCE, AXIS_TENSOR
from tpufw_torch.parallel.group import (
    ExpertGroup,
    LocalExpertGroup,
    LocalSequenceGroup,
    LocalTensorGroup,
    ProcessExpertGroup,
    ProcessSequenceGroup,
    ProcessTensorGroup,
    SequenceGroup,
    TensorGroup,
)

_current = None
_ONE_TENSOR, _ONE_EXPERT = LocalTensorGroup(1), LocalExpertGroup(1)
_tensor: TensorGroup = _ONE_TENSOR
_expert: ExpertGroup = _ONE_EXPERT


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


def tensor_group() -> TensorGroup:
    """The registered tensor group (one shard by default)."""
    return _tensor


def expert_group() -> ExpertGroup:
    """The registered expert group (one shard by default)."""
    return _expert


@contextlib.contextmanager
def use_groups(tensor: Optional[TensorGroup] = None,
               expert: Optional[ExpertGroup] = None):
    """Register ``tensor`` and ``expert`` (None: one shard) for the
    block's forwards and backwards."""
    global _tensor, _expert
    prev = _tensor, _expert
    _tensor = tensor or _ONE_TENSOR
    _expert = expert or _ONE_EXPERT
    try:
        yield _tensor, _expert
    finally:
        _tensor, _expert = prev


def model_groups(mesh) -> tuple[TensorGroup, ExpertGroup]:
    """(tensor, expert) groups of a ``DeviceMesh``: this rank's shard of
    each dimension, or one shard where the mesh has none."""
    names = mesh.mesh_dim_names or ()
    out = []
    for axis, process, local in ((AXIS_TENSOR, ProcessTensorGroup,
                                  _ONE_TENSOR),
                                 (AXIS_EXPERT, ProcessExpertGroup,
                                  _ONE_EXPERT)):
        if axis not in names:
            out.append(local)
            continue
        out.append(process(mesh.get_group(axis),
                           mesh.size(names.index(axis)),
                           mesh.get_local_rank(axis)))
    return tuple(out)
