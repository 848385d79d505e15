"""YAML-of-record run configs (port of ``tpufw.configs.loader``).

One YAML file of record per deployment under ``deploy/configs/``, loaded
into the port's own dataclasses. Resolution order (lowest to highest):

  the YAML file (``TPUFW_CONFIG=<path>`` or ``load_run_config``)
    < ``TPUFW_*`` env vars (what the deploy manifests set)

``to_env`` renders a RunConfig back to the ``TPUFW_*`` dict a manifest
would set. Schema (every section optional but ``model``)::

    name: llama3-8b-v5e16
    hardware: {slice: v5e-16, topology: 4x4, hosts: 4, chips_per_host: 4}
    model:
      preset: llama3_8b          # configs.resolve_model_preset, resnet50
      overrides: {attention_backend: flash}   # dataclasses.replace fields
    trainer:  {batch_size: 32, seq_len: 2048}  # TrainerConfig fields
    mesh:     {fsdp: 16}                       # MeshConfig fields
    pipeline: {n_stages: 2, n_microbatches: 4} # PipelineConfig (sizes
                                               # mesh.pipe)

Unknown keys anywhere are errors. The port reads the files with its own
reader (``read_yaml``) of the YAML subset they are written in, since the
machines it runs on need not have PyYAML: comments, block mappings, flow
mappings on one line, plain scalars resolved by YAML 1.1's rules as
``yaml.safe_load`` resolves them (``1.0e-4`` is a float, ``1e-4`` a
string, ``on`` a bool), single- and double-quoted scalars. Anything else
(sequences, anchors and aliases, tags, block scalars, several documents,
multi-line scalars, duplicate keys) raises naming its line.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
from dataclasses import dataclass
from typing import Any, Optional

#: Fields whose YAML spelling maps to a torch dtype on the model config.
_DTYPE_FIELDS = ("dtype", "param_dtype")


# ---------------------------------------------------------------------------
# The YAML subset.
# ---------------------------------------------------------------------------

# YAML 1.1's implicit types as PyYAML's resolver has them (yaml/resolver.py),
# each with the first characters it is tried for, in its order.
_IMPLICIT = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                            |true|True|TRUE|false|False|FALSE
                            |on|On|ON|off|Off|OFF)$""", re.X),
     "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                            |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                            |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                            |[-+]?\.(?:inf|Inf|INF)
                            |\.(?:nan|NaN|NAN))$""", re.X),
     "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                          |[-+]?0[0-7_]+
                          |[-+]?(?:0|[1-9][0-9_]*)
                          |[-+]?0x[0-9a-fA-F_]+
                          |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X),
     "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$"), "~nN"),
    ("timestamp", re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9]"),
     "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
# Characters that start something outside the subset.
_UNSUPPORTED_START = {"&": "an anchor", "*": "an alias", "!": "a tag",
                      "|": "a block scalar", ">": "a block scalar",
                      "%": "a directive", "@": "a reserved indicator",
                      "`": "a reserved indicator", "?": "a complex key"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}


class YamlSubsetError(ValueError):
    """Input outside the YAML subset ``read_yaml`` takes, or malformed."""


def _sexagesimal(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    """PyYAML's ``construct_yaml_int``."""
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _float(text: str) -> float:
    """PyYAML's ``construct_yaml_float``."""
    v = text.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _plain(text: str, where: str):
    """A plain scalar resolved as ``yaml.safe_load`` resolves it."""
    if text and text[0] in _UNSUPPORTED_START:
        raise YamlSubsetError(
            f"{where}: {_UNSUPPORTED_START[text[0]]} ({text!r}) is outside "
            "the YAML subset this reader takes")
    if text.startswith(("- ", "[", "{")) or text == "-" or re.search(
            r":(\s|$)", text):
        raise YamlSubsetError(f"{where}: unexpected {text!r}")
    first = text[:1]
    for tag, pattern, starts in _IMPLICIT:
        if first and first not in starts:
            continue
        if not first and tag != "null":
            continue
        if not pattern.match(text):
            continue
        if tag == "bool":
            return _BOOLS[text.lower()]
        if tag == "float":
            return _float(text)
        if tag == "int":
            return _int(text)
        if tag == "null":
            return None
        raise YamlSubsetError(
            f"{where}: {text!r} resolves to YAML's {tag} type, outside the "
            "subset this reader takes")
    return text


def _quoted(s: str, i: int, where: str) -> tuple[str, int]:
    """The quoted scalar starting at ``s[i]`` and the index after it."""
    quote, out, i = s[i], [], i + 1
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            code = s[i + 2:i + 2 + width] if width else ""
            if not width or len(code) != width or not re.fullmatch(
                    r"[0-9a-fA-F]+", code):
                raise YamlSubsetError(f"{where}: bad escape in {s!r}")
            out.append(chr(int(code, 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise YamlSubsetError(
        f"{where}: unterminated quoted scalar (multi-line scalars are "
        "outside the subset)")


class _Flow:
    """A flow mapping or scalar on one line, by recursive descent."""

    def __init__(self, s: str, where: str):
        self.s, self.i, self.where = s, 0, where

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i:self.i + 1]

    def value(self, stops: str):
        self.ws()
        c = self.peek()
        if c == "{":
            return self.mapping()
        if c == "[":
            raise YamlSubsetError(
                f"{self.where}: sequences are outside the subset this reader "
                "takes (no file of record has one)")
        if c in ("'", '"'):
            v, self.i = _quoted(self.s, self.i, self.where)
            return v
        return _plain(self.plain(stops), self.where)

    def plain(self, stops: str) -> str:
        """Plain text up to a stop character or ': '."""
        j = self.i
        while j < len(self.s):
            c = self.s[j]
            if c in stops:
                break
            if c == ":" and ":" in stops and (
                    j + 1 == len(self.s) or self.s[j + 1] in " \t,[]{}"):
                break
            j += 1
        text, self.i = self.s[self.i:j].strip(), j
        return text

    def expect(self, c: str) -> None:
        self.ws()
        if self.peek() != c:
            raise YamlSubsetError(
                f"{self.where}: expected {c!r} at column {self.i + 1} of "
                f"{self.s!r}")
        self.i += 1

    def mapping(self) -> dict:
        self.expect("{")
        out: dict = {}
        while True:
            self.ws()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.value(":,}")
            self.ws()
            if self.peek() == ":":
                self.i += 1
                self.ws()
                val = None if self.peek() in (",", "}") else self.value(",}")
            else:
                val = None
            _put(out, key, val, self.where)
            self.ws()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise YamlSubsetError(
                    f"{self.where}: expected ',' or '}}' in {self.s!r}")

    def whole(self):
        v = self.value("")
        self.ws()
        if self.i != len(self.s):
            raise YamlSubsetError(
                f"{self.where}: unexpected {self.s[self.i:]!r} after a value "
                "(flow mappings must close on their line)")
        return v


def _put(out: dict, key, val, where: str) -> None:
    if isinstance(key, dict):
        raise YamlSubsetError(f"{where}: a collection as a key")
    if key in out:
        raise YamlSubsetError(f"{where}: duplicate key {key!r}")
    out[key] = val


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a blank,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " \t{[,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str) -> Optional[tuple[str, str]]:
    """(key text, value text) of a block mapping line, or None when the
    line holds no ``key:``."""
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
            continue
        if c in ("'", '"') and (i == 0 or text[i - 1] in " \t{[,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text)
                                          or text[i + 1] in " \t"):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def read_yaml(text: str, source: str = "<yaml>"):
    """``yaml.safe_load(text)`` for the subset the files of record are
    written in (the module doc); raises YamlSubsetError, naming the line,
    for anything else."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        body = _strip_comment(raw)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent:indent + 1] == "\t":
            raise YamlSubsetError(f"{where}: a tab in the indentation")
        content = body[indent:]
        if content == "?" or content.startswith("? "):
            raise YamlSubsetError(
                f"{where}: a complex key is outside the subset")
        if content in ("---", "...") or content.startswith(("--- ", "%")):
            raise YamlSubsetError(
                f"{where}: document markers and directives (several "
                "documents) are outside the subset")
        lines.append((where, indent, content))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        where, _, content = lines[i]
        raise YamlSubsetError(f"{where}: unexpected {content!r}")
    return value


def _block(lines, i: int, indent: int):
    """The block node at ``lines[i]`` (indent ``indent``) and the index of
    the first line after it."""
    where, _, content = lines[i]
    if content.startswith("- ") or content == "-":
        raise YamlSubsetError(
            f"{where}: block sequences are outside the subset this reader "
            "takes (no file of record has one)")
    if _split_key(content, where) is None:
        # A lone scalar or flow mapping.
        if i + 1 < len(lines) and lines[i + 1][1] >= indent:
            raise YamlSubsetError(
                f"{lines[i + 1][0]}: multi-line scalars are outside the "
                "subset")
        return _Flow(content, where).whole(), i + 1
    out: dict = {}
    while i < len(lines):
        where, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"{where}: unexpected indentation")
        kv = _split_key(content, where)
        if kv is None:
            raise YamlSubsetError(
                f"{where}: expected 'key: value' (multi-line scalars and "
                f"block sequences are outside the subset), got {content!r}")
        key_text, rest = kv
        if key_text[:1] in ("'", '"'):
            key, end = _quoted(key_text, 0, where)
            if key_text[end:].strip():
                raise YamlSubsetError(f"{where}: bad key {key_text!r}")
        else:
            key = _plain(key_text, where)
        i += 1
        if rest:
            val = _Flow(rest, where).whole()
            if i < len(lines) and lines[i][1] > indent:
                raise YamlSubsetError(
                    f"{lines[i][0]}: multi-line scalars are outside the "
                    "subset")
        elif i < len(lines) and lines[i][1] > indent:
            val, i = _block(lines, i, lines[i][1])
        else:
            val = None
        _put(out, key, val, where)
    return out, i


# ---------------------------------------------------------------------------
# Run configs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareConfig:
    """Slice shape of record: what the manifest's nodeSelector must match."""

    slice: str = "v5e-1"
    topology: Optional[str] = None
    hosts: int = 1
    chips_per_host: int = 1

    @property
    def n_chips(self) -> int:
        return self.hosts * self.chips_per_host


@dataclass(frozen=True)
class RunConfig:
    name: str
    hardware: HardwareConfig
    model_preset: str
    model_cfg: Any  # a model family's config, or ResNetConfig
    trainer: Any  # TrainerConfig (LM) | VisionTrainerConfig (resnet)
    mesh: Any  # MeshConfig
    pipeline: Any = None  # Optional[PipelineConfig] (train_pipeline runs)

    @property
    def family(self) -> str:
        return type(self.model_cfg).__name__.removesuffix("Config").lower()


def _reject_unknown(section: str, given: dict, allowed: set[str]) -> None:
    unknown = set(given) - allowed
    if unknown:
        raise ValueError(
            f"{section}: unknown keys {sorted(unknown)}; "
            f"allowed: {sorted(allowed)}"
        )


def _section(raw: dict, name: str, path) -> dict:
    sec = raw.get(name) or {}
    if not isinstance(sec, dict):
        raise ValueError(f"{path}: section {name} must be a mapping")
    return sec


def _build_dataclass(cls, section: str, given: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    _reject_unknown(section, given, fields)
    return cls(**given)


def resolve_model_preset(preset: str):
    """Preset name -> model config: ``configs.resolve_model_preset``'s
    names, plus ``resnet50``."""
    from tpufw_torch.configs.presets import resolve_model_preset as resolve

    if preset == "resnet50":
        from tpufw_torch.models.resnet import ResNetConfig

        return ResNetConfig()
    return resolve(preset)


def _apply_model_overrides(cfg, overrides: dict):
    import torch

    fields = {f.name for f in dataclasses.fields(cfg)}
    _reject_unknown(f"model.overrides ({type(cfg).__name__})",
                    overrides, fields)
    coerced = dict(overrides)
    for k in _DTYPE_FIELDS:
        if isinstance(coerced.get(k), str):
            dtype = getattr(torch, coerced[k], None)
            if not isinstance(dtype, torch.dtype):
                raise ValueError(
                    f"model.overrides.{k}: unknown dtype {coerced[k]!r}")
            coerced[k] = dtype
    if isinstance(coerced.get("rope_scaling"), dict):
        from tpufw_torch.models.llama import RopeScaling

        _reject_unknown(
            "model.overrides.rope_scaling",
            coerced["rope_scaling"],
            {f.name for f in dataclasses.fields(RopeScaling)},
        )
        coerced["rope_scaling"] = RopeScaling(**coerced["rope_scaling"])
    return dataclasses.replace(cfg, **coerced)


def load_run_config(path: str | os.PathLike) -> RunConfig:
    """Parse one YAML of record into the port's own dataclasses."""
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train.trainer import TrainerConfig
    from tpufw_torch.train.vision import VisionTrainerConfig

    raw = read_yaml(pathlib.Path(path).read_text(), str(path))
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    _reject_unknown(
        str(path), raw,
        {"name", "hardware", "model", "trainer", "mesh", "pipeline"},
    )
    model_sec = raw.get("model")
    if not isinstance(model_sec, dict) or "preset" not in model_sec:
        raise ValueError(f"{path}: required section model.preset missing")
    _reject_unknown("model", model_sec, {"preset", "overrides"})

    model_cfg = _apply_model_overrides(
        resolve_model_preset(model_sec["preset"]),
        model_sec.get("overrides") or {},
    )
    hardware = _build_dataclass(HardwareConfig, "hardware",
                                _section(raw, "hardware", path))
    trainer_cls = (VisionTrainerConfig if model_sec["preset"] == "resnet50"
                   else TrainerConfig)
    trainer = _build_dataclass(trainer_cls, "trainer",
                               _section(raw, "trainer", path))
    mesh = _build_dataclass(MeshConfig, "mesh", _section(raw, "mesh", path))
    pipeline = None
    if raw.get("pipeline"):
        from tpufw_torch.parallel.pipeline import PipelineConfig

        pipeline = _build_dataclass(PipelineConfig, "pipeline",
                                    _section(raw, "pipeline", path))
        if mesh.pipe == 1:
            mesh = dataclasses.replace(mesh, pipe=pipeline.n_stages)
        elif mesh.pipe != pipeline.n_stages:
            raise ValueError(
                f"{path}: mesh.pipe={mesh.pipe} != "
                f"pipeline.n_stages={pipeline.n_stages}"
            )
        pipeline.validate(model_cfg, trainer.batch_size)

    # The mesh must cover the chips the hardware declares.
    per_slice = dict(
        mesh.sizes(max(1, hardware.n_chips // max(1, mesh.dcn_data)))
    )
    mesh_chips = mesh.dcn_data
    for v in per_slice.values():
        mesh_chips *= v
    if hardware.n_chips != mesh_chips:
        raise ValueError(
            f"{path}: mesh covers {mesh_chips} chips but hardware "
            f"declares {hardware.n_chips} ({hardware.slice})"
        )
    return RunConfig(
        name=raw.get("name") or pathlib.Path(path).stem,
        hardware=hardware,
        model_preset=model_sec["preset"],
        model_cfg=model_cfg,
        trainer=trainer,
        mesh=mesh,
        pipeline=pipeline,
    )


#: TrainerConfig/MeshConfig fields -> the TPUFW_* env names the deploy
#: manifests use (``workloads.env`` strips the prefix and lowercases).
_TRAINER_ENV = {
    "batch_size": "BATCH_SIZE",
    "seq_len": "SEQ_LEN",
    "total_steps": "TOTAL_STEPS",
    "lr": "LR",
    "warmup_steps": "WARMUP_STEPS",
    "log_every": "LOG_EVERY",
    "checkpoint_dir": "CHECKPOINT_DIR",
    "checkpoint_every": "CHECKPOINT_EVERY",
    "loss_chunk_size": "LOSS_CHUNK_SIZE",
    "loss_chunk_dtype": "LOSS_CHUNK_DTYPE",
    "eval_every": "EVAL_EVERY",
    "eval_batches": "EVAL_BATCHES",
    "grad_accum": "GRAD_ACCUM",
    "adam_mu_dtype": "ADAM_MU_DTYPE",
    "handle_preemption": "HANDLE_PREEMPTION",
    "preemption_sync_every": "PREEMPTION_SYNC_EVERY",
}
_VISION_ENV = {
    "batch_size": "BATCH_SIZE",
    "image_size": "IMAGE_SIZE",
    "num_classes": "NUM_CLASSES",
    "total_steps": "TOTAL_STEPS",
    "checkpoint_dir": "CHECKPOINT_DIR",
    "checkpoint_every": "CHECKPOINT_EVERY",
    "handle_preemption": "HANDLE_PREEMPTION",
    "preemption_sync_every": "PREEMPTION_SYNC_EVERY",
}
_MESH_ENV = {
    "data": "MESH_DATA",
    "pipe": "MESH_PIPE",
    "fsdp": "MESH_FSDP",
    "expert": "MESH_EXPERT",
    "sequence": "MESH_SEQUENCE",
    "tensor": "MESH_TENSOR",
    "dcn_data": "MESH_DCN_DATA",
}


def to_env(run: RunConfig, *, defaults_too: bool = False) -> dict[str, str]:
    """Render a RunConfig as the TPUFW_* env dict a manifest would set:
    with ``defaults_too=False`` only the values that differ from the
    dataclasses' defaults."""
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train.trainer import TrainerConfig
    from tpufw_torch.train.vision import VisionTrainerConfig

    env = {} if run.family == "resnet" else {"TPUFW_MODEL": run.model_preset}
    trainer_map = (
        (run.trainer, _VISION_ENV, VisionTrainerConfig())
        if run.family == "resnet"
        else (run.trainer, _TRAINER_ENV, TrainerConfig())
    )
    for cfg, mapping, defaults in (
        trainer_map,
        (run.mesh, _MESH_ENV, MeshConfig()),
    ):
        for field, suffix in mapping.items():
            if field == "pipe" and run.pipeline is not None:
                # Pipeline manifests size the pipe axis via
                # TPUFW_PIPE_STAGES (one source of truth).
                continue
            val = getattr(cfg, field)
            if not defaults_too and val == getattr(defaults, field):
                continue
            if val is None:
                continue
            env[f"TPUFW_{suffix}"] = str(val)
    if run.pipeline is not None:
        env["TPUFW_PIPE_STAGES"] = str(run.pipeline.n_stages)
        env["TPUFW_PIPE_MICROBATCHES"] = str(run.pipeline.n_microbatches)
        if run.pipeline.schedule != "gpipe":
            env["TPUFW_PIPE_SCHEDULE"] = run.pipeline.schedule
    return env
