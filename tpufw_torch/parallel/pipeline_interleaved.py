"""Interleaved virtual-stage 1F1B: bubble / v, activations O(v*S) (port of
``tpufw.parallel.pipeline_interleaved``).

Each stage owns ``v`` non-contiguous chunks of n_layers / (v*S) layers:
chunk c = k*S + d lives on stage d = c mod S, stacked ``[v, S,
layers_per_chunk, ...]`` (``pipeline.to_virtual_stages``). The fill
still takes S-1 ticks but each is v times smaller: bubble
(S-1)/(vM+S-1), for v times more hand-offs a microbatch.

Schedule (M % S == 0, microbatch j = g*S + r):
  - forward of chunk k, mb (g, r) on stage d at t = d + g*vS + k*S + r:
    stage d's forward sub-ticks are the contiguous window [d, d + vM);
  - backward at t = (vS-1) + (S-1-d) + g*vS + (v-1-k)*S + r (last chunk
    first); the last chunk's forward and backward of a microbatch share
    a tick on stage S-1, whose loss epilogue feeds the backward;
  - T = vM + (v+1)S - 2 ticks; the forward hand-off wraps from stage
    S-1 to stage 0 (chunk k-1 to chunk k), the cotangent from 0 to S-1;
  - the stash is a ring of 2vS chunk inputs indexed by the forward
    offset, its lifetime at most 2vS - 2 ticks.

The engine is ``pipeline_1f1b.manual_value_and_grad``. ``tpufw`` also
counts the traces of its chunk body (``TRACE_COUNTS``) to pin that a
compile traces it O(1) times whatever M; eager PyTorch traces nothing,
so the port has no such counter (a divergence by design): the chunk
body runs once per real sub-tick, which the flash launch counts show.
"""

from __future__ import annotations

from typing import Optional

from tpufw_torch.parallel.pipeline import Gang
from tpufw_torch.parallel.pipeline_1f1b import manual_value_and_grad


def pipeline_interleaved_value_and_grad(params, batch, cfg, pipe, group=None,
                                        backend=None, loss_chunk_size=None,
                                        loss_chunk_dtype="bfloat16",
                                        gang: Optional[Gang] = None):
    """(mean token loss, gradients) through the interleaved schedule, for
    params in the ``[v, S, ...]`` layout."""
    if not pipe.virtual_layout:
        raise ValueError(
            f"schedule='{pipe.schedule}' is not the interleaved "
            "schedule; use pipeline_1f1b / GPipe entry points")
    return manual_value_and_grad(params, batch, cfg, pipe, group, backend,
                                 loss_chunk_size, loss_chunk_dtype, gang)
