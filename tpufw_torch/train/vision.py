"""Image-classification training (port of ``tpufw.train.vision``): ViT
and ResNet under one ``VisionTrainer``, on one GPU or sharded over a
gang's mesh.

The optimizer is ``tpufw``'s: ``add_decayed_weights(weight_decay)`` on the
parameters of rank > 1 (no decay on norm scales and biases), then nesterov
SGD at ``momentum`` over ``warmup_cosine_decay_schedule(0, lr, warmup,
total)``, the learning rate taken at the pre-increment count as optax
does: step 0's rate is 0, and its momentum still accumulates. In torch
that is ``SGD(nesterov=True, dampening=0)`` in two parameter groups.

A step runs the model in train mode (a ResNet's BatchNorm normalizes with
the batch statistics and updates its running ones), softmax cross-entropy
on integer labels, and reports the loss and the accuracy. ``run`` syncs
the host every ``sync_every`` steps, after the first and after the last,
metering images/s and MFU from ``flops_per_image`` with the LM trainer's
``Meter`` (an image is its "token"); at those points it checkpoints
(``train.checkpoint``: parameters, BN statistics, momentum and step) and
stops on SIGTERM with a forced save (``train.preemption``).
``maybe_restore`` resumes from the latest checkpoint.

In a gang (a ``torch.distributed`` process group), as ``tpufw`` runs one
program over the batch sharded on (``data``, ``fsdp``): the model is
built whole on each rank from the seed, then ``fully_shard``ed, each ViT
encoder block or ResNet block and then the root (``sharding.shard_model``);
each rank feeds the rows of its batch shard (``batch_rows``); the loss
and the accuracy are the global batch's (``sharding.backward_global_mean``)
and BatchNorm's training statistics too (``BatchNorm.stat_group``). The
checkpoint is gathered tensor by tensor (BN statistics and momentum
included) and resumes at any world size.

Under a ``tensor`` axis above 1 (a gang's, or one process's
``LocalTensorGroup`` from ``mesh_cfg.tensor``) the model splits as
``tpufw``'s logical axes name it (``parallel.tensor``: ViT's heads and
MLP width, both families' class head), each rank keeping its shards
before ``fully_shard`` shards them over the batch ranks of its tensor
coordinate; the cross-entropy goes over the class shards
(``vocab_parallel_token_ce``). The tensor ranks of a batch shard feed
the same rows: the means and BatchNorm's statistics run over the batch
ranks alone. ``sequence``, ``pipe`` and ``expert`` axes above 1 are
refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpufw_torch.mesh import MeshConfig, build_mesh, mesh_shape
from tpufw_torch.ops.loss import vocab_parallel_token_ce
from tpufw_torch.parallel.context import model_groups, use_groups
from tpufw_torch.parallel.group import LocalExpertGroup, LocalTensorGroup
from tpufw_torch.parallel.tensor import cut_model, cut_tensor
from tpufw_torch.train import sharding
from tpufw_torch.train.checkpoint import (
    CheckpointManager,
    check_identity,
    config_identity,
    config_to_dict,
)
from tpufw_torch.train.metrics import Meter, StepMetrics
from tpufw_torch.train.trainer import (
    batch_to_device,
    run_steps,
    warmup_cosine_decay,
)
from tpufw_torch.utils.hardware import detect_chip, resolve_device


def vision_model(cfg, device=None, seed: int = 0):
    """``ViT`` for a ``ViTConfig``, ``ResNet`` for a ``ResNetConfig``,
    weights drawn from ``seed`` on ``device``."""
    from tpufw_torch.models.resnet import ResNet, ResNetConfig
    from tpufw_torch.models.vit import ViT, ViTConfig

    if isinstance(cfg, ViTConfig):
        return ViT(cfg, device=device, seed=seed)
    if isinstance(cfg, ResNetConfig):
        return ResNet(cfg, device=device, seed=seed)
    raise TypeError(f"not a vision config: {type(cfg).__name__}")


def vision_blocks(model) -> list:
    """The blocks a gang shards one by one: a ViT's encoder blocks, a
    ResNet's bottleneck blocks."""
    if hasattr(model, "block_names"):
        return [getattr(model, name) for name in model.block_names]
    return list(model.blocks)


@dataclasses.dataclass
class VisionTrainerConfig:
    batch_size: int = 256
    image_size: int = 224
    num_classes: int = 1000
    total_steps: int = 100
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_steps: int = 5
    # Checkpoints (train.checkpoint), as TrainerConfig's.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    # SIGTERM -> stop with a forced checkpoint (train.preemption).
    handle_preemption: bool = True
    preemption_sync_every: int = 1
    # Steps between host syncs (TrainerConfig.sync_every).
    sync_every: int = 1


class VisionSGD:
    """Masked weight decay + nesterov SGD + warmup-cosine schedule, with
    optax's arithmetic (see the module doc). ``step`` applies the update
    from the parameters' ``.grad``."""

    def __init__(self, params, cfg: VisionTrainerConfig):
        self.params = [p for p in params if p.requires_grad]
        decay = [p for p in self.params if p.ndim > 1]
        rest = [p for p in self.params if p.ndim <= 1]
        self.sgd = torch.optim.SGD(
            [{"params": decay, "weight_decay": cfg.weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=0.0, momentum=cfg.momentum, dampening=0.0, nesterov=True)
        self.lr, self.warmup = cfg.lr, cfg.warmup_steps
        self.decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
        self.count = 0

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup,
                                   self.decay_steps, 0.0)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()

    def state_dict(self) -> dict:
        return {"count": self.count, "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Inverse of ``state_dict``; momentum saved whole (a checkpoint's,
        any world size) is sharded as its parameter is."""
        saved = state["sgd"]
        params = [p for g in self.sgd.param_groups for p in g["params"]]
        if any(sharding.is_dtensor(p) for p in params):
            saved = dict(saved, state={
                i: {k: (sharding.shard_like(v, params[i])
                        if isinstance(v, torch.Tensor) else v)
                    for k, v in st.items()}
                for i, st in saved["state"].items()})
        self.sgd.load_state_dict(saved)
        self.count = int(state["count"])


def vision_train_step(model, optimizer: VisionSGD, batch: dict) -> dict:
    """One supervised step on device tensors, images [B, H, W, C] and
    labels [B]: {loss, accuracy} as device tensors. Under a process group
    the batch is this rank's rows (a sharded model) and both are the
    global batch's; under a tensor group the loss goes over the class
    shards."""
    from tpufw_torch.parallel.context import tensor_group

    model.train()
    optimizer.zero_grad()
    parts = model(batch["images"], logit_shards=True)
    labels = batch["labels"].long()
    tp = tensor_group()
    if tp.size == 1:
        ce = F.cross_entropy(parts[0].float(), labels)
    else:
        ce = vocab_parallel_token_ce(
            parts, tp.ranges(model.cfg.num_classes), labels, tp,
            z_loss_weight=0.0).mean()
    n = torch.tensor(float(labels.shape[0]), device=labels.device)
    loss = sharding.backward_global_mean(ce, n)
    optimizer.step()
    with torch.no_grad():
        logits = tp.gather([p.detach() for p in parts], -1)
        accuracy = sharding.global_mean(
            (logits.argmax(-1) == labels).float().mean(), n)
    return {"loss": loss, "accuracy": accuracy}


def check_tensor_split(cfg, tensor: int) -> None:
    """ValueError naming the dimension when ``tensor`` does not divide a
    dimension of the vision config ``cfg`` that it splits: a ViT's heads
    and MLP width, and either family's classes."""
    dims = [("num_classes", cfg.num_classes)]
    if hasattr(cfg, "n_heads"):
        dims += [("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff)]
    for name, v in dims:
        if v % tensor:
            raise ValueError(f"mesh tensor={tensor} must divide {name}={v} "
                             "for tensor parallelism")


class VisionTrainer:
    """Builds a ``ViT`` or ``ResNet`` and its optimizer and runs the step
    loop with images/s/GPU and MFU metrics: on one device, or, when a
    process group is initialized, sharded over the gang's mesh of
    ``mesh_cfg`` (default ``MeshConfig()``: every rank on ``fsdp``, as in
    ``tpufw``); ``cfg.batch_size`` is then global. One process takes
    ``mesh_cfg.tensor`` as a ``LocalTensorGroup`` (every shard in turn).
    A ``sequence`` or ``pipe`` axis above 1 raises NotImplementedError
    (ROADMAP.md Queue 1 item 12f), an ``expert`` one ValueError."""

    def __init__(self, model_cfg, cfg: VisionTrainerConfig, mesh_cfg=None,
                 device=None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        mesh_cfg = mesh_cfg or MeshConfig()
        # The DeviceMesh of the gang (None: one device, unsharded).
        self.mesh = None
        # (process group, size) of the batch ranks of this rank's tensor
        # coordinate, when the model is split in a gang.
        self.batch_ranks = None
        if sharding.active():
            sharding.refuse_split_rows(mesh_cfg, "VisionTrainer")
            self.mesh = build_mesh(mesh_cfg, sharding.world_size(),
                                   self.device.type)
            self.groups = model_groups(self.mesh)
            n = self.batch_shard()[1]
            if cfg.batch_size % n:
                raise ValueError(
                    f"batch_size {cfg.batch_size} does not divide over {n} "
                    "batch shards")
        else:
            mesh_shape(dataclasses.replace(mesh_cfg, tensor=1, expert=1), 1)
            self.groups = (LocalTensorGroup(max(mesh_cfg.tensor, 1)),
                           LocalExpertGroup(max(mesh_cfg.expert, 1)))
        tp, ep = self.groups
        if ep.size > 1:
            raise ValueError(
                f"mesh expert axis has size {ep.size} but "
                f"{type(model_cfg).__name__} has no experts to shard over it")
        if tp.size > 1:
            check_tensor_split(model_cfg, tp.size)
            if self.gang:
                self.batch_ranks = sharding.batch_group(self.mesh)
        # {parameter name: split} of the split parameters a rank of a
        # tensor-parallel gang holds its shards of (set by ``_shard``).
        self.splits: dict = {}
        self.model = None
        self.optimizer: Optional[VisionSGD] = None
        self.step = 0
        self.preempted = False
        # The last run()'s CheckpointManager (its saves' numbers).
        self.checkpointer = None

    def init_state(self, seed: int = 0, state_dict=None):
        """Weights from ``seed``, or ``state_dict`` when given (e.g.
        ``interop.vision_params_from_flax``); fresh optimizer at step 0."""
        self.model = vision_model(self.model_cfg, self.device, seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self._shard(self.model)
        self.optimizer = VisionSGD(self.model.parameters(), self.cfg)
        self.step = 0
        return self.model

    @property
    def gang(self) -> bool:
        """True when the model is sharded over a process group's mesh."""
        return self.mesh is not None

    def batch_shard(self) -> tuple[int, int]:
        """(this rank's batch shard, the number of batch shards), as
        ``Trainer.batch_shard``; (0, 1) on one device."""
        return sharding.batch_shard(self.mesh) if self.gang else (0, 1)

    def _shard(self, model) -> None:
        """Shard ``model`` (whole on this rank's device) over the mesh, its
        split parameters cut to this rank's shards first; BatchNorm's
        statistics over every batch rank's rows."""
        if not self.gang:
            return
        if self.batch_ranks is not None:
            self.splits = cut_model(model, self.groups)
        sharding.shard_model(model, self.mesh, vision_blocks(model))
        if sharding.world_size() > 1:
            import torch.distributed as dist

            from tpufw_torch.models.resnet import BatchNorm

            group = (dist.group.WORLD if self.batch_ranks is None
                     else self.batch_ranks[0])
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.stat_group = group

    def _param_splits(self) -> list:
        """The split of each parameter the optimizer holds, in its order
        (() when replicated)."""
        names = {id(p): k for k, p in self.model.named_parameters()}
        return [self.splits.get(names[id(p)], ())
                for g in self.optimizer.sgd.param_groups for p in g["params"]]

    def _split_momentum(self, state: dict, fn) -> dict:
        """``VisionSGD.state_dict``'s form with each split parameter's
        momentum replaced by ``fn(momentum, split)``."""
        splits = self._param_splits()
        sgd = state["sgd"]
        return dict(state, sgd=dict(sgd, state={
            i: {k: (fn(v, splits[i]) if isinstance(v, torch.Tensor)
                    and splits[i] else v) for k, v in st.items()}
            for i, st in sgd["state"].items()}))

    def whole_state(self) -> dict:
        """The model's state dict with every tensor whole on this rank (in
        a gang a collective)."""
        return sharding.full_state_dict(self.state_dict()["model"])

    def state_dict(self) -> dict:
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.splits:
            # A checkpoint holds whole tensors: the split ones gather.
            model = {k: (sharding.SplitPart(v, self.splits[k], self.groups)
                         if k in self.splits else v)
                     for k, v in model.items()}
            opt = self._split_momentum(
                opt, lambda v, sp: sharding.SplitPart(v, sp, self.groups))
        return {"step": self.step,
                "config": config_identity(self.model_cfg),
                "model_config": config_to_dict(self.model_cfg),
                "model": model,
                "optimizer": opt}

    def load_state_dict(self, state: dict) -> None:
        """Resume from ``state_dict()``'s output (in a gang, whole tensors
        on any device, as a checkpoint holds them); ValueError for another
        model's."""
        check_identity(state["config"], self.model_cfg, "the checkpoint")
        tensors = state["model"]
        if self.gang:
            tensors = {k: v.to(self.device) for k, v in tensors.items()}
        self.model = vision_model(self.model_cfg, "meta")
        self.model.load_state_dict(tensors, assign=True)
        self._shard(self.model)
        self.optimizer = VisionSGD(self.model.parameters(), self.cfg)
        opt = state["optimizer"]
        if self.splits:
            opt = self._split_momentum(
                opt, lambda v, sp: cut_tensor(v, sp, self.groups))
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint under ``cfg.checkpoint_dir``,
        if there is one. A gang's ranks must see the same latest step;
        ValueError on every rank otherwise."""
        if not self.cfg.checkpoint_dir:
            return False
        mgr = CheckpointManager(self.cfg.checkpoint_dir)
        try:
            latest = mgr.latest_step()
            latest = sharding.gang_agree(-1 if latest is None else latest,
                                         "the latest checkpoint step")
            if latest < 0:
                return False
            self.load_state_dict(mgr.restore(latest, device=self.device,
                                             mapped=self.gang))
            return True
        finally:
            mgr.close()

    def train_step(self, batch: dict) -> dict:
        with contextlib.ExitStack() as stack:
            stack.enter_context(use_groups(*self.groups))
            if self.batch_ranks is not None:
                stack.enter_context(sharding.batch_ranks(*self.batch_ranks))
            out = vision_train_step(self.model, self.optimizer,
                                    batch_to_device(batch, self.device))
        self.step += 1
        return out

    def run(
        self,
        data: Iterator[dict],
        flops_per_image: Optional[float] = None,
        on_metrics: Callable[[StepMetrics], None] | None = None,
        shutdown=None,
    ) -> list[StepMetrics]:
        """Train up to ``total_steps`` (a restored run trains what is
        left) through the LM trainer's ``run_steps``: one ``StepMetrics``
        per host sync, images as tokens, checkpoints and the SIGTERM
        stop."""
        if self.model is None:
            self.init_state()
        meter = Meter(tokens_per_step=self.cfg.batch_size,
                      flops_per_token=flops_per_image or 0.0,
                      chip=detect_chip(self.device),
                      n_gpus=sharding.world_size() if self.gang else 1)
        return run_steps(self, data, meter, on_metrics, shutdown)


def batch_rows(data: Iterator[dict], shard: int, n: int) -> Iterator[dict]:
    """The rows ``[shard·b, (shard+1)·b)`` of each global batch of
    ``data`` (b its rows / ``n``): what batch shard ``shard`` of ``n``
    feeds. Every rank draws the same global batches, so a gang's global
    batch is one process's."""
    for batch in data:
        b = len(next(iter(batch.values()))) // n
        yield {k: v[shard * b:(shard + 1) * b] for k, v in batch.items()}


def synthetic_images(
    batch_size: int,
    image_size: int = 224,
    num_classes: int = 1000,
    seed: int = 0,
    pool: int = 4,
    device=None,
) -> Iterator[dict]:
    """Cycles a pool of ``pool`` batches of standard-normal NHWC fp32
    images and uniform int64 labels, drawn once from a numpy ``seed``:
    the same bytes as ``tpufw.train.synthetic_images``. With ``device``
    the pool is staged there once and its tensors are yielded (``tpufw``'s
    ``on_device``), so a step uploads nothing."""
    rng = np.random.default_rng(seed)
    batches = [
        {
            "images": rng.standard_normal(
                (batch_size, image_size, image_size, 3)
            ).astype(np.float32),
            "labels": rng.integers(
                0, num_classes, (batch_size,), dtype=np.int64
            ),
        }
        for _ in range(pool)
    ]
    if device is not None:
        batches = [batch_to_device(b, torch.device(device)) for b in batches]
    i = 0
    while True:
        yield batches[i % pool]
        i += 1
