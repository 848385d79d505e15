"""The 1F1B pipeline schedule, and the manual-backward engine it shares
with the zero-bubble and interleaved schedules (port of
``tpufw.parallel.pipeline_1f1b``).

GPipe differentiates the whole microbatch stream, so every in-flight
stage input is kept for its backward: activation memory grows with M.
1F1B interleaves one forward and one backward sub-tick per tick instead,
a microbatch's backward starting as soon as its loss gradient exists:

- stage s runs the forward of microbatch ``t - s`` under
  ``torch.no_grad`` and stashes its input in a ring of 2S slots;
- stage s runs the backward of microbatch ``t - 2(S-1) + s``: the stage
  recomputed from the stash with grad enabled, the input and parameter
  gradients from one ``torch.autograd.grad``;
- the last stage's forward and backward of a microbatch share a tick:
  its loss epilogue (final norm, head, token CE sum) feeds the backward
  at once;
- a stash written at tick j + s is read at j + 2(S-1) - s, so the slots
  ``j mod 2S`` never collide (``_Ring`` checks it);
- activations go s -> s+1 and cotangents s -> s-1 once a tick, both in
  one hand-off of the pipe group.

The stage stacks' gradients accumulate in fp32 where the stage is held;
stage 0 scatter-adds its input cotangents into the embedding's; the last
stage's epilogue gives the final norm's and the head's. Under a gang the
embedding, final norm and head gradients and the loss sum are summed
over the ranks of this rank's tensor coordinate (``tpufw``'s pipe x data
x fsdp; its ``psum_scatter`` of them onto the vocab axis is a layout
choice, an all-reduce gives the same numbers), the stage gradients over
the batch shards; everything is then divided by the gang's target count.

Tensor parallelism inside a stage needs no schedule of its own: the
stage math's ``enter`` and ``reduce`` (Megatron's f and g, autograd
Functions) sit inside each stage's graph, so the per-stage
``torch.autograd.grad`` of a B (or ZB-H1's W) sub-tick takes the sums
over ``tensor`` itself, once a phase: the input cotangent's in B, the
replicated leaves' in W (``tpufw`` writes the same operators as custom
VJPs for its per-stage VJPs).

The engine (``manual_value_and_grad``) runs the tick maps of
``tpufw``'s three schedules: 1F1B (the interleaved maps at v = 1),
interleaved (``pipeline_interleaved``: v chunks a stage) and ZB-H1
(``pipeline_zb1``: the backward split into an input-gradient and a
deferred weight-gradient phase). Like GPipe's, it runs a stage only on
its real sub-ticks (``tpufw`` masks bubble sub-ticks it runs).

Scope, ``tpufw``'s ``_check_1f1b``: Llama-family blocks (Qwen biases,
Mistral's window) and dense DeepSeek-MLA, over data, fsdp and tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpufw_torch.parallel.context import expert_group
from tpufw_torch.parallel.group import LocalPipeGroup
from tpufw_torch.parallel.pipeline import (
    Gang,
    PipelineConfig,
    _embed,
    _is_gemma,
    _is_mla,
    _is_moe,
    _stage,
    ce_sum,
    check_group,
    check_split,
    chunk_params,
    reduce_grads,
    tree_leaves,
    tree_map,
)


def _check_1f1b(cfg, schedule: str = "1f1b") -> None:
    """``tpufw``'s envelope of the manual schedules: the Llama family and
    dense MLA, over data, fsdp and tensor (an expert group above one
    shard is refused)."""
    if _is_gemma(cfg) or _is_moe(cfg) or (_is_mla(cfg) and cfg.moe):
        raise NotImplementedError(
            f"schedule='{schedule}' implements Llama-family and dense "
            "DeepSeek-MLA blocks; use the GPipe schedule for "
            "Gemma/Mixtral"
        )
    ep = expert_group().size
    if ep > 1:
        raise NotImplementedError(
            f"{schedule} composes with data/fsdp/tensor; mesh axis expert "
            f"has size {ep}")


class _Ring:
    """A stash of ``n`` slots; writing a slot whose value is still live is
    a schedule bug (the stash bound is the schedule's claim)."""

    def __init__(self, n: int):
        self.slots = [None] * n

    def put(self, i: int, x: torch.Tensor) -> None:
        i %= len(self.slots)
        if self.slots[i] is not None:
            raise AssertionError(f"stash slot {i} of {len(self.slots)} is "
                                 "still live (a schedule bug)")
        self.slots[i] = x

    def get(self, i: int) -> torch.Tensor:
        return self.slots[i % len(self.slots)]

    def take(self, i: int) -> torch.Tensor:
        x = self.get(i)
        self.slots[i % len(self.slots)] = None
        return x


def tick_plan(pipe: PipelineConfig, t: int, s: int):
    """(F, B, W) sub-ticks of stage ``s`` at tick ``t``, each a (chunk,
    microbatch) pair or None: ``tpufw``'s maps. Forward of chunk k,
    microbatch j = g*S + r at t = s + g*vS + k*S + r; backward at
    (vS-1) + (S-1-s) + g*vS + (v-1-k)*S + r (at v = 1: t - s and
    t - 2(S-1) + s); ZB-H1's weight gradient of j at j + 3(S-1) - 2s."""
    n_s, m = pipe.n_stages, pipe.n_microbatches
    v = pipe.n_virtual if pipe.virtual_layout else 1
    vm, vs = v * m, v * n_s
    f = b = w = None
    tau = t - s
    if 0 <= tau < vm:
        f = ((tau % vs) // n_s, (tau // vs) * n_s + tau % n_s)
    tau = t - (vs - 1) - (n_s - 1 - s)
    if 0 <= tau < vm:
        b = (v - 1 - (tau % vs) // n_s, (tau // vs) * n_s + tau % n_s)
    if pipe.schedule == "zb1":
        jw = t - 3 * (n_s - 1) + 2 * s
        if 0 <= jw < m:
            w = (0, jw)
    return f, b, w


def _leaf_copies(tree, grad: bool):
    return tree_map(lambda a: a.detach().requires_grad_(grad), tree)


def manual_value_and_grad(
    params: dict,
    batch,
    cfg,
    pipe: PipelineConfig,
    group=None,
    backend: Optional[str] = None,
    loss_chunk_size: Optional[int] = None,
    loss_chunk_dtype="bfloat16",
    gang: Optional[Gang] = None,
    train: bool = True,
):
    """(mean token loss, gradients: a tree like ``params``) of one step
    through ``pipe.schedule`` ("1f1b", "interleaved" or "zb1"); with
    ``train`` False the forward sub-ticks alone: (loss, target count).
    Under a gang both are the global batch's on every rank."""
    from tpufw_torch.train.trainer import shift_and_mask

    _check_1f1b(cfg, pipe.schedule)
    check_split(cfg)
    if pipe.schedule == "gpipe":
        raise ValueError("the GPipe schedule is pipeline.gpipe_value_and_grad")
    group = group or LocalPipeGroup(pipe.n_stages)
    gang = gang or Gang()
    check_group(pipe, group)
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    inputs, targets, seg_in, mask = shift_and_mask(batch)
    pipe.validate(cfg, inputs.shape[0])
    backend = backend or cfg.attention_backend
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    n_tok = torch.clamp(gang.batch_sum(mask.sum().detach().clone()), min=1.0)
    n_s, m = pipe.n_stages, pipe.n_microbatches
    virtual = pipe.virtual_layout
    v = pipe.n_virtual if virtual else 1
    zb = pipe.schedule == "zb1"
    tok, tgt, msk = (x.chunk(m) for x in (inputs, targets, mask))
    segs = seg_in.chunk(m) if seg_in is not None else [None] * m
    held = group.indices
    last = n_s - 1
    stages = params["stages"]
    dev = inputs.device
    like = torch.empty(tok[0].shape + (cfg.d_model,), dtype=cfg.dtype,
                       device=dev)

    n_slots = (3 if zb else 2) * v * n_s
    stash = {s: _Ring(n_slots) for s in held}
    cot = {s: _Ring(n_s) for s in held} if zb else None
    acc = (tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                    stages) if train else None)
    f32 = dict(dtype=torch.float32, device=dev)
    g_embed = (torch.zeros(params["embed"].shape, **f32) if train else None)
    g_fnorm = torch.zeros(params["final_norm"].shape, **f32)
    g_head = torch.zeros(params["head"].shape, **f32) if train else None
    loss_sum = torch.zeros((), **f32)

    def slot(k: int, j: int) -> int:
        # The forward offset tau of (chunk k, microbatch j = g*S + r).
        return (j // n_s) * v * n_s + k * n_s + j % n_s

    def chunk(k, s):
        return chunk_params(stages, group, s, k, virtual)

    def acc_add(k, s, grads: dict) -> None:
        for (_, a), (_, g) in zip(tree_leaves(chunk_params(
                acc, group, s, k, virtual)), tree_leaves(grads)):
            a.add_(g)

    def epilogue(y, j):
        """(loss, dy) of the last chunk's output for microbatch j; the
        final norm's and head's gradients accumulated."""
        nonlocal g_fnorm, g_head
        head = {"final_norm": params["final_norm"], "head": params["head"]}
        if not train:
            return ce_sum(head, y, tgt[j], msk[j], cfg, loss_chunk_size,
                          loss_chunk_dtype), None
        with torch.enable_grad():
            yy = y.detach().requires_grad_()
            head = _leaf_copies(head, True)
            loss = ce_sum(head, yy, tgt[j], msk[j], cfg, loss_chunk_size,
                          loss_chunk_dtype)
            dy, dfn, dhd = torch.autograd.grad(
                loss, [yy, head["final_norm"], head["head"]])
        g_fnorm += dfn
        g_head += dhd
        return loss.detach(), dy.to(y.dtype)

    def run_f(s, k, j, f_send):
        """Forward of chunk k, microbatch j on stage s: stash its input;
        the last chunk's output goes through the epilogue, returning the
        cotangent of the backward of this tick."""
        nonlocal loss_sum
        x_in = (_embed(params, tok[j], cfg) if s == 0 and k == 0
                else f_recv.pop(s))
        with torch.no_grad():
            y, _ = _stage(chunk(k, s), x_in, cfg, backend, segs[j])
        if train:
            stash[s].put(slot(k, j), x_in)
        if s == last and k == v - 1:
            loss_j, dy = epilogue(y, j)
            loss_sum += loss_j
            return dy
        f_send[s] = y
        return None

    def run_b(s, k, j, g_in, b_send):
        """Backward of chunk k, microbatch j on stage s from the stash:
        the input gradient to the previous stage (stage 0's into the
        embedding's), and, but under ZB-H1, the parameter gradients."""
        x = stash[s].get(slot(k, j)) if zb else stash[s].take(slot(k, j))
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            pv = _leaf_copies(chunk(k, s), not zb)
            y, _ = _stage(pv, xx, cfg, backend, segs[j])
            leaves = [] if zb else [p for _, p in tree_leaves(pv)]
            grads = torch.autograd.grad(y, [xx, *leaves], g_in)
        if zb:
            cot[s].put(j, g_in)
        else:
            it = iter(grads[1:])
            acc_add(k, s, tree_map(lambda _: next(it), pv))
        dx = grads[0]
        if s == 0 and k == 0:
            g_embed.index_add_(0, tok[j].reshape(-1).long(),
                               dx.reshape(-1, dx.shape[-1]).float())
        else:
            b_send[s] = dx

    def run_w(s, k, j):
        """ZB-H1's deferred weight gradient: the stage recomputed again
        from the stash, against the cotangent its B consumed."""
        xw, gw = stash[s].take(slot(k, j)), cot[s].take(j)
        with torch.enable_grad():
            pv = _leaf_copies(chunk(k, s), True)
            y, _ = _stage(pv, xw, cfg, backend, segs[j])
            leaves = [p for _, p in tree_leaves(pv)]
            it = iter(torch.autograd.grad(y, leaves, gw))
        acc_add(k, s, tree_map(lambda _: next(it), pv))

    f_recv, b_recv = {}, {}
    n_ticks = pipe.n_ticks() if train else v * m + n_s - 1
    for t in range(n_ticks):
        f_send, b_send = {}, {}
        for s in held:
            f, b, w = tick_plan(pipe, t, s)
            dy = run_f(s, *f, f_send) if f is not None else None
            if not train:
                continue
            if b is not None:
                k, j = b
                if s == last and k == v - 1:
                    if f != b:
                        raise AssertionError("last chunk's F and B apart")
                    g_in = dy
                else:
                    g_in = b_recv.pop(s)
                run_b(s, k, j, g_in, b_send)
            if w is not None:
                run_w(s, *w)
        fwd_expect, bwd_expect = set(), set()
        for s in held:
            f, b, _ = tick_plan(pipe, t + 1, s)
            if f is not None and not (s == 0 and f[0] == 0):
                fwd_expect.add(s)
            if train and b is not None and not (s == last and b[0] == v - 1):
                bwd_expect.add(s)
        f_recv, b_recv = group.handoff(f_send, b_send, fwd_expect,
                                       bwd_expect, like)

    loss = gang.world_sum(loss_sum) / n_tok
    if not train:
        return loss, n_tok
    parts = {"embed": g_embed, "stages": acc, "final_norm": g_fnorm,
             "head": g_head}
    grads = reduce_grads({k: parts[k] for k in params}, gang)
    inv = 1.0 / n_tok
    grads = {k: (tree_map(lambda g: g * inv, v_) if isinstance(v_, dict)
                 else v_ * inv) for k, v_ in grads.items()}
    return loss, _cast_like(grads, params)


def _cast_like(grads: dict, params: dict) -> dict:
    out = {}
    for k, g in grads.items():
        if isinstance(g, dict):
            out[k] = _cast_like(g, params[k])
        else:
            out[k] = g.to(params[k].dtype)
    return out


def pipeline_1f1b_value_and_grad(params, batch, cfg, pipe, group=None,
                                 backend=None, loss_chunk_size=None,
                                 loss_chunk_dtype="bfloat16",
                                 gang: Optional[Gang] = None):
    """(mean token loss, gradients) through the 1F1B schedule: the
    counterpart of ``pipeline.gpipe_value_and_grad`` with O(S) activation
    memory."""
    if pipe.schedule != "1f1b":
        raise ValueError(f"schedule={pipe.schedule!r} is not '1f1b'")
    return manual_value_and_grad(params, batch, cfg, pipe, group, backend,
                                 loss_chunk_size, loss_chunk_dtype, gang)
