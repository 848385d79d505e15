"""ZB-H1-style zero-bubble 1F1B: the backward split into B and W phases
(port of ``tpufw.parallel.pipeline_zb1``).

Only the input-gradient half (B) of a stage's backward is on the
critical path; the weight-gradient half (W) has no consumer until the
optimizer step, so it is deferred into ticks that were bubble. Each tick
runs up to three sub-ticks on stage s:

  F: forward of microbatch  jf = t - s            (stash its input)
  B: input gradient of      jb = t - 2(S-1) + s   (dx to s-1 at once)
  W: weight gradient of     jw = t - 3(S-1) + 2s  (accumulated locally)

W of microbatch j runs S-1-s ticks after its B. The activation stash is
a ring of 3S slots (written by F, read by B, freed by W) and the
cotangent stash a ring of S (B parks the output cotangent it consumed;
on stage S-1, B then W in one tick). As in ``tpufw``, W re-runs the
stage forward (a recompute's VJP cannot ride across ticks), so a
microbatch costs three stage forwards per stage: F's, B's and W's.
Analytic bubble (S-1)/(3M+S-1). The engine is
``pipeline_1f1b.manual_value_and_grad``; the scope is 1F1B's (the Llama
family and dense MLA, canonical [S, lps, ...] stacks).
"""

from __future__ import annotations

from typing import Optional

from tpufw_torch.parallel.pipeline import Gang
from tpufw_torch.parallel.pipeline_1f1b import manual_value_and_grad


def pipeline_zb1_value_and_grad(params, batch, cfg, pipe, group=None,
                                backend=None, loss_chunk_size=None,
                                loss_chunk_dtype="bfloat16",
                                gang: Optional[Gang] = None):
    """(mean token loss, gradients) through the zero-bubble H1
    schedule."""
    if pipe.schedule != "zb1":
        raise ValueError(f"schedule={pipe.schedule!r} is not 'zb1'")
    return manual_value_and_grad(params, batch, cfg, pipe, group, backend,
                                 loss_chunk_size, loss_chunk_dtype, gang)
