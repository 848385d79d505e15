"""Pipeline-parallel trainer: the Trainer's surface over the pipeline
schedules (port of ``tpufw.train.pipeline_trainer``).

The layer stack runs on a pipe of stages (``parallel.pipeline``) instead
of the model's trunk; the functional pipeline params (a tree of leaf
tensors, stage stacks ``[S, lps, ...]`` or, interleaved, ``[v, S, lpc,
...]``) replace the ``nn.Module``, and the rest is the Trainer's
machinery: ``LlamaAdamW`` (``default_optimizer``), ``Meter`` (tokens/s
per GPU and MFU), ``CheckpointManager`` and the SIGTERM stop through
``run_steps``, ``shift_and_mask``'s packed-batch masking, the chunked CE,
and the token-weighted held-out evaluation.

The pipe group: without a process group, a ``LocalPipeGroup`` holds every
stage in this process (one GPU, or the CPU); under one, the mesh of
``mesh_cfg`` (dims ``data``, ``pipe``, ``fsdp``) gives each rank its
stage (a ``ProcessPipeGroup`` over the ``pipe`` dimension) and makes the
``data`` and ``fsdp`` ranks batch shards: each feeds the ``batch_size /
(data · fsdp)`` rows of its shard (``batch_shard``), and the loss,
gradient norm and evaluation are the global batch's. A caller may pass a
``LocalPipeGroup`` under a process group too: every rank then holds every
stage and the ranks are batch shards only. ``grad_accum`` above 1 raises
(microbatching is the schedule: size ``n_microbatches``), as in
``tpufw``; so does a mesh whose ``pipe`` is not the stage count.
Checkpoints hold the whole model whatever the gang (a rank's stages
gathered over the pipe), so a gang's run resumes in one process, or in
another gang, of the same stages.

Tensor and expert axes inside the stages (``parallel.pipeline``'s
``leaf_split``): in a gang the mesh's ``tensor`` and ``expert``
dimensions give each rank its shards of the split stage leaves (its
``TensorGroup``/``ExpertGroup``), the batch shards and the loss run over
the ranks of its (``expert``, ``tensor``) coordinate, the clip's norm
counts a split leaf's shards once each, and a checkpoint gathers the
split leaves whole (restore cuts them again). One process holds every
shard as it holds every stage: ``mesh_cfg``'s ``tensor`` and ``expert``
become ``LocalTensorGroup``/``LocalExpertGroup`` of those sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import torch

from tpufw_torch.mesh import MeshConfig, build_mesh, mesh_shape
from tpufw_torch.parallel.context import model_groups, use_groups
from tpufw_torch.parallel.group import (
    LocalExpertGroup,
    LocalPipeGroup,
    LocalTensorGroup,
    ProcessPipeGroup,
)
from tpufw_torch.parallel.pipeline import (
    Gang,
    PipelineConfig,
    check_group,
    check_split,
    cut_stages,
    init_pipeline_params,
    leaf_split,
    pipeline_eval,
    stage_axis,
    stage_slice,
    tree_leaves,
    tree_map,
    value_and_grad,
)
from tpufw_torch.parallel.tensor import cut_tensor, gather_split
from tpufw_torch.train import sharding
from tpufw_torch.train.checkpoint import (
    CheckpointManager,
    check_identity,
    config_identity,
)
from tpufw_torch.train.metrics import Meter, StepMetrics
from tpufw_torch.obs import Telemetry
from tpufw_torch.train.trainer import (
    TrainerConfig,
    batch_to_device,
    default_optimizer,
    emit_eval,
    resolve_autotune,
    run_evaluation,
    run_steps,
    start_telemetry,
)
from tpufw_torch.utils.hardware import detect_chip, resolve_device


class PipelineTrainer:
    """Drives pipeline-parallel training with the Trainer's surface."""

    def __init__(
        self,
        model_cfg,
        pipe: PipelineConfig,
        trainer_cfg: TrainerConfig,
        mesh_cfg: Optional[MeshConfig] = None,
        device=None,
        group=None,
    ):
        if mesh_cfg is None:
            mesh_cfg = MeshConfig(pipe=pipe.n_stages, fsdp=-1)
        if mesh_cfg.pipe != pipe.n_stages:
            raise ValueError(
                f"mesh_cfg.pipe={mesh_cfg.pipe} != "
                f"PipelineConfig.n_stages={pipe.n_stages}"
            )
        pipe.validate(model_cfg, trainer_cfg.batch_size)
        if trainer_cfg.grad_accum != 1:
            raise NotImplementedError(
                "PipelineTrainer does not implement TrainerConfig fields "
                "['grad_accum']; unset them (microbatching is the schedule: "
                "size PipelineConfig.n_microbatches)"
            )
        self.model_cfg = model_cfg
        self.pipe = pipe
        self.cfg = trainer_cfg
        self.device = resolve_device(device)
        self.mesh_cfg = mesh_cfg
        self.mesh = None
        self.gang = Gang()
        if group is not None and not isinstance(group, LocalPipeGroup):
            raise TypeError(
                f"group must be a LocalPipeGroup, got {type(group).__name__}"
                " (a process group's pipe comes from the mesh)")
        local_cfg = dataclasses.replace(mesh_cfg, pipe=1)
        if sharding.active():
            world = sharding.world_size()
            if group is None and pipe.n_stages > 1:
                self.mesh = build_mesh(mesh_cfg, world, self.device.type)
                coord = dict(zip(self.mesh.mesh_dim_names,
                                 self.mesh.get_coordinate()))
                group = ProcessPipeGroup(self.mesh.get_group("pipe"),
                                         pipe.n_stages, coord["pipe"])
                group.connect(self.device)
            else:
                self.mesh = build_mesh(local_cfg, world, self.device.type)
            self.groups = model_groups(self.mesh)
            coord_group = None
            if any(g.size > 1 for g in self.groups):
                dims = [d for d in ("data", "pipe", "fsdp")
                        if d in self.mesh.mesh_dim_names]
                coord_group = sharding.batch_group(self.mesh, dims)[0]
            self.gang = Gang(batch_groups=tuple(
                self.mesh.get_group(d) for d in ("data", "fsdp")
                if self.mesh.size(self.mesh.mesh_dim_names.index(d)) > 1),
                active=True, coord_group=coord_group)
        else:
            # One process holds every stage and every tensor and expert
            # shard: the mesh's other axes must resolve to one device.
            mesh_shape(dataclasses.replace(local_cfg, tensor=1, expert=1), 1)
            self.groups = (LocalTensorGroup(max(mesh_cfg.tensor, 1)),
                           LocalExpertGroup(max(mesh_cfg.expert, 1)))
        self.group = group or LocalPipeGroup(pipe.n_stages)
        check_group(pipe, self.group)
        with self._groups():
            check_split(model_cfg)
            if pipe.schedule != "gpipe":
                from tpufw_torch.parallel.pipeline_1f1b import _check_1f1b

                _check_1f1b(model_cfg, pipe.schedule)
        # {stage leaf path: split} of the split stage leaves a rank of a
        # tensor- or expert-parallel gang holds its shards of.
        self.splits: dict = {}
        self.params: Optional[dict] = None
        self.optimizer = None
        self.step = 0
        self.preempted = False
        self.checkpointer = None
        # The run's Telemetry (Trainer's discipline): the shared
        # disabled one between runs.
        self.telemetry = Telemetry.disabled()
        # TuneResult of the last apply_autotune; None until cfg.autotune
        # resolves in run().
        self.last_tune = None

    # -- state ---------------------------------------------------------

    @property
    def holds_all(self) -> bool:
        """True when this process holds every stage."""
        return len(self.group.indices) == self.group.size

    def _groups(self):
        """The tensor and expert groups registered for the stage math."""
        tp, ep = self.groups
        return use_groups(tensor=tp, expert=ep)

    @property
    def cut(self) -> bool:
        """True when this process holds part of the tensor or expert
        shards (a gang's rank), whose split stage leaves are cut."""
        return not all(g.holds_all for g in self.groups)

    def batch_shard(self) -> tuple[int, int]:
        """(this rank's batch shard, the number of batch shards): (0, 1)
        without a process group."""
        return sharding.batch_shard(self.mesh) if self.mesh is not None \
            else (0, 1)

    def init_state(self, seed: int = 0, params: Optional[dict] = None):
        """Weights drawn from ``seed`` (``init_pipeline_params``, only
        this process's stages), or ``params`` (a whole pipeline tree,
        e.g. ``interop.pipeline_params_from_jax``'s), and a fresh optimizer
        at step 0. Returns the params."""
        if params is None:
            params = init_pipeline_params(self.model_cfg, self.pipe, seed,
                                          self.device, self.group)
            params = dict(params, stages=cut_stages(
                params["stages"], self.groups, self.pipe.virtual_layout))
        else:
            params = self._held(params)
        self._assign(params)
        self._fresh_optimizer()
        return self.params

    def _held(self, params: dict) -> dict:
        """This process's part of a whole tree, on its device."""
        params = tree_map(lambda a: a.to(self.device, copy=True), params)
        return dict(params, stages=stage_slice(
            params["stages"], self.group, self.pipe.virtual_layout,
            self.groups))

    def _assign(self, params: dict) -> None:
        self.params = tree_map(lambda a: a.detach().requires_grad_(), params)
        if self.cut:
            virtual = self.pipe.virtual_layout
            self.splits = {
                path: leaf_split(path, a.ndim, virtual)
                for path, a in tree_leaves(params) if path.startswith(
                    "stages/") and leaf_split(path, a.ndim, virtual)}

    def _leaves(self) -> list:
        return [p for _, p in tree_leaves(self.params)]

    def _paths(self) -> list:
        return [path for path, _ in tree_leaves(self.params)]

    def _fresh_optimizer(self) -> None:
        self.optimizer = default_optimizer(
            self._leaves(), lr=self.cfg.lr,
            warmup_steps=self.cfg.warmup_steps,
            total_steps=self.cfg.total_steps,
            mu_dtype=self.cfg.adam_mu_dtype)
        self.step = 0

    def _whole(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """A stage stack (or its moment) of every stage and shard: this
        rank's gathered over its tensor and expert axes, then over the
        pipe; other tensors as they are."""
        if path in self.splits:
            t = gather_split(t.detach(), self.splits[path], self.groups)
        if not path.startswith("stages/") or self.holds_all:
            return t
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.group.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.group.group)
        return torch.cat(parts, dim=stage_axis(self.pipe.virtual_layout))

    def _part(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """Inverse of ``_whole``: this rank's stages and shards of a whole
        tensor."""
        if not path.startswith("stages/"):
            return t
        if not self.holds_all:
            ax = stage_axis(self.pipe.virtual_layout)
            t = t[(slice(None),) * ax + (list(self.group.indices),)]
        if path in self.splits:
            t = cut_tensor(t, self.splits[path], self.groups)
        return t

    def _map_moments(self, opt: dict, fn) -> dict:
        """``fn(tensor, leaf path)`` on each moment of a ``LlamaAdamW``
        state dict."""
        paths = self._paths()
        opt = dict(opt)
        if "adamw" in opt:
            inner = dict(opt["adamw"])
            inner["state"] = {
                i: {k: (fn(v, paths[int(i)]) if k != "step" else v)
                    for k, v in st.items()}
                for i, st in inner["state"].items()}
            opt["adamw"] = inner
        else:
            for key in ("mu", "nu"):
                opt[key] = [fn(t, p) for t, p in zip(opt[key], paths)]
        return opt

    def whole_params(self) -> dict:
        """The whole params, detached (this rank's stages and shards
        gathered over the pipe and its tensor and expert axes in a gang:
        a collective)."""
        paths = iter(self._paths())
        return tree_map(lambda a: self._whole(a.detach(), next(paths)),
                        self.params)

    def state_dict(self) -> dict:
        """Everything a resumed run needs: step, the whole params and
        optimizer state (gathered over the pipe and the shards), the
        model config's identity and the pipeline's shape."""
        return {"step": self.step,
                "config": config_identity(self.model_cfg),
                "pipeline": dataclasses.asdict(self.pipe),
                "params": self.whole_params(),
                "optimizer": self._map_moments(self.optimizer.state_dict(),
                                               self._whole)}

    def load_state_dict(self, state: dict) -> None:
        """Resume from ``state_dict()``'s output; ValueError for another
        model's, or another stage layout's (stage count, chunks)."""
        check_identity(state["config"], self.model_cfg, "the checkpoint")
        saved = {k: state["pipeline"][k] for k in ("n_stages", "n_virtual")}
        mine = {k: getattr(self.pipe, k) for k in saved}
        if saved != mine:
            raise ValueError(
                f"the checkpoint's stage layout {saved} differs from this "
                f"trainer's {mine}")
        self._assign(self._held(state["params"]))
        self._fresh_optimizer()
        opt = self._map_moments(
            state["optimizer"],
            lambda t, path: self._part(t, path).to(self.device))
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint under ``cfg.checkpoint_dir``,
        if there is one; a gang's ranks must see the same latest step."""
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
                                             mapped=self.gang.active))
            return True
        finally:
            mgr.close()

    # -- steps ---------------------------------------------------------

    def _grad_norm(self, grads: list) -> torch.Tensor:
        """The global gradient norm: each leaf's squares summed over the
        ranks holding its other parts (a stage stack's over the pipe, a
        split leaf's over its tensor and expert axes), a replicated
        leaf's counted once."""
        import torch.distributed as dist

        by_axis = {g.axis: g for g in self.groups}
        buckets: dict = {}
        for g, path in zip(grads, self._paths()):
            axes = tuple(a for a, _ in self.splits.get(path, ())
                         if by_axis[a].size > 1)
            if path.startswith("stages/") and not self.holds_all:
                axes += ("pipe",)
            buckets.setdefault(axes, []).append(g)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for axes, gs in buckets.items():
            sq = sum(g.float().square().sum() for g in gs)
            for a in axes:
                pg = self.group.group if a == "pipe" else by_axis[a].group
                dist.all_reduce(sq, group=pg)
            total = total + sq
        return torch.sqrt(total)

    def train_step(self, batch: dict) -> dict:
        """One optimizer update on this rank's rows; {loss, grad_norm}
        of the global batch."""
        if self.params is None:
            raise RuntimeError("train_step() before init_state()")
        batch = batch_to_device(batch, self.device)
        with self._groups():
            loss, grads = value_and_grad(
                self.params, batch, self.model_cfg, self.pipe, self.group,
                loss_chunk_size=self.cfg.loss_chunk_size,
                loss_chunk_dtype=self.cfg.loss_chunk_dtype, gang=self.gang)
        self.optimizer.zero_grad()
        by_path = dict(tree_leaves(grads))
        for path, p in tree_leaves(self.params):
            p.grad = by_path[path].to(p.dtype)
        norm_fn = None if self.holds_all and not self.cut \
            else self._grad_norm
        grad_norm = self.optimizer.step(norm_fn)
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def evaluate(self, data: Iterator[dict],
                 n_batches: Optional[int] = None) -> dict:
        """Token-weighted held-out loss and perplexity through the
        forward-only pipeline, the train objective's shift and masks."""
        if self.params is None:
            raise RuntimeError("evaluate() before init_state()/restore")
        with self._groups():
            return run_evaluation(
                data, n_batches,
                lambda b: pipeline_eval(
                    self.params, batch_to_device(b, self.device),
                    self.model_cfg, self.pipe, self.group,
                    loss_chunk_size=self.cfg.loss_chunk_size,
                    loss_chunk_dtype=self.cfg.loss_chunk_dtype,
                    gang=self.gang))

    def run(
        self,
        data: Iterator[dict],
        model_flops_per_token: float,
        on_metrics: Callable[[StepMetrics], None] | None = None,
        eval_data: Callable[[], Iterator[dict]] | None = None,
        on_eval: Callable[[dict], None] | None = None,
        shutdown=None,
    ) -> list[StepMetrics]:
        """Train up to ``total_steps`` (a restored run trains what is
        left) through ``run_steps``: a ``StepMetrics`` per host sync,
        the held-out evaluation every ``eval_every`` steps, checkpoints
        and the SIGTERM stop; ``tpufw``'s telemetry as ``Trainer.run``'s,
        the step program ``pipeline_step``, plus the analytic bubble
        gauge and a ``pipeline_tick`` span (the window's step time over
        the schedule's ticks) per window."""
        tel = start_telemetry(
            self, f"pipeline:{type(self.model_cfg).__name__}",
            {"trainer": dataclasses.asdict(self.cfg),
             "pipeline": dataclasses.asdict(self.pipe)})
        try:
            resolve_autotune(self, tel)
            if self.params is None:
                self.init_state()
            meter = Meter(
                tokens_per_step=self.cfg.batch_size * (self.cfg.seq_len - 1),
                flops_per_token=model_flops_per_token,
                chip=detect_chip(self.device),
                n_gpus=sharding.world_size() if self.gang.active else 1,
                registry=tel.registry,
            )
        except BaseException:
            tel.close()
            raise
        if tel.registry is not None:
            tel.registry.gauge(
                "tpufw_pipeline_bubble_fraction",
                "Analytic pipeline bubble fraction of the active schedule",
            ).set(self.pipe.bubble_fraction())

        def after_sync():
            every = self.cfg.eval_every
            if every and eval_data is not None and not self.step % every:
                ev = self.evaluate(eval_data(), self.cfg.eval_batches)
                ev["step"] = self.step
                emit_eval(tel, ev)
                if on_eval:
                    on_eval(ev)

        def on_window(sm):
            tel.tracer.complete(
                "pipeline_tick", sm.step_time_s / max(1, self.pipe.n_ticks()))

        return run_steps(self, data, meter, on_metrics, shutdown,
                         after_sync=after_sync, log_every=self.cfg.log_every,
                         telemetry=tel, program="pipeline_step",
                         workload="train_pipeline", on_window=on_window)

