"""Training checkpoints in torch format (port of ``tpufw.train.checkpoint``).

One directory per step, ``<directory>/<step>/``, holding ``state.pt``
(``torch.save`` of the state: nested dicts and lists of tensors and
plain values) and ``meta.json`` (the step and a checksum of every
tensor). A save is written under a temporary name, flushed to the disk
and moved into place with ``os.replace``, so a save killed half way
leaves no step directory behind; names that are not a bare step number
are ignored.

Saves are asynchronous, as Orbax's are: ``save`` copies the state's
tensors into pinned host buffers on the current stream (reused from the
last save when the shapes agree), records an event and returns; a
background thread waits on the event and writes. The step path pays the
enqueue and, before it, the wait for the previous write. ``restore``
maps the file (``torch.load(mmap=True)``), moves each tensor to the
caller's device and checks it against the checksum taken at the save.

Under a process group (a training gang, ``train.sharding``) the state's
sharded tensors (DTensors, and the ``SplitPart``s of a tensor- or
expert-parallel gang) are gathered whole one at a time, every rank
taking part; rank 0 alone copies them to the host and writes, and each
checksum is of the whole tensor. Every rank waits at a barrier before
the next save looks at the directory and when the manager closes, and
the ranks must agree on whether a step is already on disk (ValueError
otherwise: a rank that sees another directory).
``restore`` reads the whole state on every rank. So a checkpoint does
not depend on the world size: a gang's resumes in one process, and
one process's in a gang.

Telemetry (``tpufw``'s hooks): a save or a forced save becomes a
``checkpoint_save`` event and a restore a ``checkpoint_restore`` event
in ``events``; the restore and the final drain (``wait``, which the run
loop calls after its last save) run under their own ``tracer`` spans,
outside the loop's ``checkpoint`` span, so the goodput ledger books them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import torch

from tpufw_torch.train.sharding import (
    SplitPart,
    active,
    full_tensor,
    gang_agree,
)

_STEP_DIR = re.compile(r"^\d+$")
_WORD = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _checksum_words(t: torch.Tensor) -> torch.Tensor:
    """[2] int64 on ``t``'s device: the tensor's bits as int64 words,
    summed plain and weighted by position (mod 251, so that a permutation
    shows), both wrapping mod 2**64. No host sync."""
    w = t.detach().reshape(-1)
    if w.dtype == torch.bool:
        w = w.to(torch.int8)
    w = w.view(_WORD[w.element_size()]).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 251 + 1
    return torch.stack([w.sum(), (w * pos).sum()])


def _walk(tree, prefix=""):
    """(path, tensor) for every tensor of a nested dict/list state."""
    if isinstance(tree, (torch.Tensor, SplitPart)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")


def _map(tree, fn, prefix=""):
    """``tree`` with every tensor replaced by ``fn(path, tensor)``."""
    if isinstance(tree, (torch.Tensor, SplitPart)):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return tree


def _device_checksums(state) -> tuple[list[str], Optional[torch.Tensor]]:
    """(paths, [N, 2] int64 checksums on the state's device), no sync;
    a sharded tensor's are its whole tensor's."""
    items = list(_walk(state))
    if not items:
        return [], None
    return [p for p, _ in items], torch.stack(
        [_checksum_words(full_tensor(t)) for _, t in items])


def checksums(state) -> dict[str, list[int]]:
    """{path: [plain, weighted] checksum} over every tensor of ``state``
    (one host sync)."""
    paths, sums = _device_checksums(state)
    return dict(zip(paths, [] if sums is None else sums.tolist()))


def _fsync(path: str) -> None:
    """Flush a file's or a directory's entries to the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for _, t in _walk(state))


class CheckpointManager:
    """Saves and restores step-numbered training states in ``directory``.

    ``save_interval_steps``: a non-forced ``save`` writes only steps that
    are multiples of it. ``max_to_keep``: older steps are deleted once a
    newer one is on disk. ``saves`` holds each save's numbers: step,
    bytes, ``enqueue_s`` (the step path's share), of which ``wait_s`` (for
    the previous write) and ``pin_s`` (pinning host buffers, the first
    save's cost), and, once written, ``write_s``."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, events=None, tracer=None):
        if save_interval_steps < 1:
            raise ValueError(
                f"save_interval_steps must be >= 1, got {save_interval_steps}")
        from tpufw_torch.obs import events as events_mod
        from tpufw_torch.obs import trace as trace_mod

        self.events = events if events is not None else events_mod.NULL
        self.tracer = tracer if tracer is not None else trace_mod.NULL
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None
        self._host: dict[str, torch.Tensor] = {}
        self.saves: list[dict] = []
        self._record: dict = {}
        # Set by a save under a process group: close() then waits at a
        # barrier for rank 0's write.
        self._gang_saved = False

    def all_steps(self) -> list[int]:
        """Steps on disk, ascending (a save in flight is not one yet)."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if _STEP_DIR.match(name) and os.path.isfile(
                    os.path.join(path, "meta.json")):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Start writing ``state`` (or what the callable ``state``
        returns, made only when the save happens) as ``step``; False when
        the interval skips it or the step is already saved (a forced save
        of a step the schedule already wrote is satisfied, not an
        error)."""
        if not force and step % self.save_interval_steps:
            return False
        gang = active()
        t0 = time.perf_counter()
        if gang:
            # Rank 0's last write on disk before any rank looks.
            self._join()
            self._barrier()
            self._gang_saved = True
        saved = step == self._pending or step in self.all_steps()
        if gang:
            gang_agree(int(saved), f"whether step {step} is on disk")
        if saved:
            if force:
                self.events.emit("checkpoint_save", step=step, forced=True,
                                 saved=False)
            return False
        self.events.emit("checkpoint_save", step=step, forced=force,
                         saved=True)
        if callable(state):
            state = state()
        self._join()
        record = {"step": step, "wait_s": time.perf_counter() - t0,
                  "pin_s": 0.0}
        self._record = record
        if gang:
            host, paths, sums = self._gather(state)
            if host is None:  # not rank 0: nothing to write
                record["enqueue_s"] = time.perf_counter() - t0
                return True
        else:
            host = _map(state, self._to_host)
            paths, sums = _device_checksums(state)
        if sums is not None:
            sums = self._to_host("#checksums", sums)
        event = None
        if any(t.is_cuda for _, t in _walk(state)):
            event = torch.cuda.Event()
            event.record()
        self._pending = step
        record["bytes"] = state_bytes(host)
        self.saves.append(record)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, paths, sums, event, record),
            name="tpufw-checkpoint", daemon=True)
        self._thread.start()
        record["enqueue_s"] = time.perf_counter() - t0
        return True

    def _gather(self, state):
        """(host copy on rank 0 else None, paths, [N, 2] checksums) of a
        gang's state: each sharded tensor gathered whole in turn (a
        collective), checksummed, copied to rank 0's host buffer, freed."""
        import torch.distributed as dist

        writer = dist.get_rank() == 0
        sums = []

        def take(path, t):
            t = full_tensor(t)
            sums.append(_checksum_words(t))
            return self._to_host(path, t) if writer else None

        host = _map(state, take)
        paths = [p for p, _ in _walk(state)]
        return (host if writer else None), paths, (
            torch.stack(sums) if sums else None)

    @staticmethod
    def _barrier() -> None:
        import torch.distributed as dist

        dist.barrier()

    def _to_host(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into this path's pinned buffer (made or remade
        when missing or of another shape); CPU tensors are cloned."""
        if not t.is_cuda:
            return t.detach().clone()
        buf = self._host.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            t0 = time.perf_counter()
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._record["pin_s"] += time.perf_counter() - t0
            self._host[path] = buf
        buf.copy_(t.detach(), non_blocking=True)
        return buf

    def _write(self, step: int, host, paths, sums, event, record) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        try:
            if event is not None:
                event.synchronize()
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)  # and the directory, at the first save
            torch.save(host, os.path.join(tmp, "state.pt"))
            sums = {} if sums is None else dict(zip(paths, sums.tolist()))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "checksums": sums}, f)
            # On disk before the name says the step is there.
            for name in ("state.pt", "meta.json", ""):
                _fsync(os.path.join(tmp, name))
            os.replace(tmp, os.path.join(self.directory, str(step)))
            _fsync(self.directory)
            self._prune()
            record["write_s"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised by wait()
            self._error = e
            shutil.rmtree(tmp, ignore_errors=True)

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk; re-raise its error
        (the run loop's final drain, under a ``checkpoint_wait`` span)."""
        with self.tracer.span("checkpoint_wait"):
            self._join()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: Optional[int] = None, device=None,
                mapped: bool = False) -> dict:
        """The state saved as ``step`` (default: the latest), its tensors
        on ``device`` (default: the CPU), each checked against its
        checksum from the save. ``mapped``: the tensors stay mapped from
        the file on the host, each checked on ``device`` one at a time (a
        gang's restore: no rank holds the whole state on its device).
        Raises FileNotFoundError when there is none, ValueError when a
        tensor's bits changed."""
        self._join()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with self.tracer.span("checkpoint_restore", step=step):
            state = self._read(step, device, mapped)
        self.events.emit("checkpoint_restore", step=step)
        return state

    def _read(self, step: int, device, mapped: bool) -> dict:
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        state = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                           mmap=True, weights_only=True)
        dev = torch.device("cpu" if device is None else device)
        if mapped:
            items = list(_walk(state))
            sums = [_checksum_words(t.to(dev)) for _, t in items]
            got = dict(zip([p for p, _ in items],
                           torch.stack(sums).tolist() if sums else []))
        else:
            state = _map(state, lambda p, t: t.to(dev) if dev.type != "cpu"
                         else t.clone())
            got = checksums(state)
        bad = [p for p, s in meta["checksums"].items() if got.get(p) != s]
        if bad or got.keys() != meta["checksums"].keys():
            raise ValueError(
                f"checkpoint {path}: tensors differ from the save: "
                f"{bad or sorted(got.keys() ^ meta['checksums'].keys())}")
        return state

    def close(self) -> None:
        self.wait()
        if self._gang_saved:
            self._barrier()
            self._gang_saved = False
        self._host.clear()


# Fields that change how a model runs, not which weights it holds: a
# checkpoint restores into a config that differs only in these.
_RUNTIME_FIELDS = frozenset({
    "dtype", "param_dtype", "attention_backend", "remat", "remat_policy",
    "decode", "max_seq_len", "moe_dispatch", "kv_page", "kv_pages",
    "kv_quant", "quantized_weights", "scan_layers", "lora_alpha",
})


def config_to_dict(cfg) -> dict:
    """A model config as JSON-able fields plus its class name (dtypes as
    their names, rope scaling as a nested dict)."""
    fields = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = str(v).removeprefix("torch.")
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        fields[f.name] = v
    return {"class": type(cfg).__name__, "fields": fields}


def config_from_dict(d: dict):
    """Inverse of ``config_to_dict``."""
    from tpufw_torch.models import (
        DeepseekConfig,
        GemmaConfig,
        LlamaConfig,
        MixtralConfig,
    )
    from tpufw_torch.models.deepseek import YarnScaling
    from tpufw_torch.models.llama import RopeScaling

    classes = {c.__name__: c for c in (LlamaConfig, MixtralConfig,
                                       GemmaConfig, DeepseekConfig)}
    cls = classes[d["class"]]
    fields = dict(d["fields"])
    for k, v in fields.items():
        if k in ("dtype", "param_dtype"):
            fields[k] = getattr(torch, v)
        elif k == "rope_scaling" and v is not None:
            fields[k] = (YarnScaling if cls is DeepseekConfig
                         else RopeScaling)(**v)
    return cls(**fields)


def config_identity(cfg) -> dict:
    """{"name": config class, "hash": sha256 of its weight-shaping
    fields}: equal for two configs whose state dicts are interchangeable."""
    d = config_to_dict(cfg)
    arch = {k: v for k, v in d["fields"].items() if k not in _RUNTIME_FIELDS}
    blob = json.dumps(arch, sort_keys=True, default=str).encode()
    return {"name": d["class"], "hash": hashlib.sha256(blob).hexdigest()[:16]}


def check_identity(saved: dict, cfg, where: str) -> None:
    want = config_identity(cfg)
    if saved != want:
        raise ValueError(
            f"{where} holds a {saved.get('name')} (config hash "
            f"{saved.get('hash')}), not this {want['name']} (config hash "
            f"{want['hash']}): a different model")


# Bare params: the model's state dict alone, as safetensors, with the
# config beside it (the import_hf CLI's output, TPUFW_INIT_FROM's and
# TPUFW_PARAMS_CHECKPOINT's input).
PARAMS_CONFIG = "config.json"


def save_params(out_dir: str, state_dict: dict, cfg) -> list[str]:
    """Write ``state_dict`` (any device) and ``cfg`` as bare params."""
    from tpufw_torch.io.safetensors import save_sharded

    files = save_sharded(state_dict, out_dir)
    with open(os.path.join(out_dir, PARAMS_CONFIG), "w") as f:
        json.dump({"tpufw_torch_params": config_identity(cfg),
                   "config": config_to_dict(cfg)}, f, indent=1)
    return files


def _model_dtypes(cfg) -> dict:
    """{state-dict key: dtype} of ``cfg``'s model (built on the meta
    device: no memory)."""
    from tpufw_torch.models import model_for_config

    return {k: v.dtype for k, v in
            model_for_config(cfg, device="meta").state_dict().items()}


def load_params(path: str, cfg=None, device=None) -> tuple[Any, dict]:
    """(config, state dict on ``device``) of a bare-params directory,
    tensor by tensor from the mapped files. With ``cfg``, the saved model
    must be the same (``check_identity``), ``cfg`` is returned and every
    tensor is cast to the dtype ``cfg``'s model keeps it in."""
    from tpufw_torch.io.safetensors import open_dir

    with open(os.path.join(path, PARAMS_CONFIG)) as f:
        meta = json.load(f)
    if "tpufw_torch_params" not in meta:
        raise ValueError(f"{path}: not a tpufw_torch bare-params directory")
    dtypes = {} if cfg is None else _model_dtypes(cfg)
    if cfg is None:
        cfg = config_from_dict(meta["config"])
    check_identity(meta["tpufw_torch_params"], cfg, path)
    dev = torch.device("cpu" if device is None else device)
    out = {}
    for k, f in open_dir(path).items():
        t = f.get(k)
        dt = dtypes.get(k, t.dtype)
        # On the CPU in the stored dtype, own a copy, not the mapping.
        out[k] = t.clone() if dev.type == "cpu" and dt == t.dtype \
            else t.to(dev, dt)
    return cfg, out


def checkpoint_model_state(path: str, cfg, device=None) -> dict:
    """The model state dict of a training checkpoint, without its
    optimizer state: ``path`` is a step directory or a checkpoint
    directory (its latest step). The saved model must be ``cfg``'s; each
    tensor goes to ``device`` (default: CPU, mapped) in the dtype
    ``cfg``'s model keeps it in."""
    step_dir = path
    if not os.path.isfile(os.path.join(path, "state.pt")):
        step = CheckpointManager(path).latest_step()
        if step is None:
            raise FileNotFoundError(f"{path} holds no checkpoint")
        step_dir = os.path.join(path, str(step))
    state = torch.load(os.path.join(step_dir, "state.pt"), map_location="cpu",
                       mmap=True, weights_only=True)
    check_identity(state["config"], cfg, step_dir)
    dev = torch.device("cpu" if device is None else device)
    return {k: state["model"][k].to(dev, dt)
            for k, dt in _model_dtypes(cfg).items()}
