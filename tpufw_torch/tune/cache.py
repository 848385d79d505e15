"""Kept autotuner winners, keyed per machine and workload shape (port of
``tpufw.tune.cache``).

A search costs real wall time, so its winner is written to disk and a
later run of the same (machine, model config, batch/seq, mesh) skips the
search. One JSON file per key, so hosts sharing a cache volume write
their entries independently.

Layout: ``$TPUFW_TUNE_CACHE_DIR`` (default ``~/.cache/tpufw_torch/tune``:
the port's own directory, so the two packages never read each other's
winners), one ``<key>.json`` per entry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Optional

from tpufw_torch.tune.space import Candidate


def cache_dir() -> pathlib.Path:
    from tpufw_torch.workloads.env import env_opt_str

    d = env_opt_str("tune_cache_dir")
    if d:
        return pathlib.Path(d)
    return pathlib.Path.home() / ".cache" / "tpufw_torch" / "tune"


def model_config_hash(model_cfg) -> str:
    """Stable hash of everything that changes the step: non-JSON leaves
    (dtypes) are stringified, so two configs differing only in dtype get
    distinct keys."""
    if dataclasses.is_dataclass(model_cfg):
        d = dataclasses.asdict(model_cfg)
    else:
        d = dict(model_cfg)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def cache_key(
    model_cfg,
    batch_size: int,
    seq_len: int,
    mesh_shape: tuple,
    fingerprint: Optional[str] = None,
    extra: Optional[str] = None,
) -> str:
    """``fingerprint`` defaults to ``utils.profiling.machine_fingerprint``
    (the card, driver, CUDA and torch versions); ``extra`` extends the key
    with workload shape beyond the model, batch and mesh, e.g. a pipeline
    trainer's ``pp<S>x<M>``."""
    if fingerprint is None:
        from tpufw_torch.utils.profiling import machine_fingerprint

        fingerprint = machine_fingerprint()
    mesh = "x".join(str(int(m)) for m in mesh_shape)
    return (
        f"{fingerprint}-{model_config_hash(model_cfg)}"
        f"-b{batch_size}-s{seq_len}-m{mesh}"
        + (f"-{extra}" if extra else "")
    )


def load(key: str) -> Optional[dict]:
    """The entry for ``key``, or None. A corrupt file reads as a miss: the
    search runs again and overwrites it."""
    path = cache_dir() / f"{key}.json"
    try:
        with open(path) as f:
            entry = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(entry, dict) or "candidate" not in entry:
        return None
    return entry


def store(
    key: str,
    candidate: Candidate,
    median_step_s: Optional[float] = None,
    tune_s: Optional[float] = None,
    meta: Optional[dict] = None,
) -> pathlib.Path:
    d = cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{key}.json"
    entry = {
        "key": key,
        "candidate": candidate.as_dict(),
        "median_step_s": median_step_s,
        "tune_s": tune_s,
        **(meta or {}),
    }
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_candidate(key: str) -> Optional[Candidate]:
    entry = load(key)
    if entry is None:
        return None
    try:
        return Candidate.from_dict(entry["candidate"])
    except (TypeError, KeyError):
        return None
