"""safetensors files, read and written without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus
an optional ``"__metadata__"`` map of strings), then the raw little-endian
tensor bytes, offsets counted from the end of the header.

Reading maps the file (``np.memmap``, copy-on-write) and hands out views,
so a tensor costs host memory only when it is copied: a checkpoint moves to
the device one tensor at a time. bf16 has no numpy dtype; it travels as
``uint16`` and becomes ``torch.bfloat16`` through ``Tensor.view``.

Writing follows what ``transformers.save_pretrained`` writes: one
``model.safetensors``, or shards ``model-0000i-of-0000n.safetensors`` of
at most ``MAX_SHARD_BYTES`` each with a ``model.safetensors.index.json``
(``{"metadata": {"total_size"}, "weight_map": {name: file}}``), every
file's metadata ``{"format": "pt"}``.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

# safetensors dtype name -> (numpy storage dtype, torch dtype).
DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_NAME_OF = {torch_dtype: name for name, (_, torch_dtype) in DTYPES.items()}
# transformers' default max_shard_size, "5GB" (decimal).
MAX_SHARD_BYTES = 5 * 10**9
INDEX_NAME = "model.safetensors.index.json"


def read_header(path) -> tuple[dict, Optional[dict], int]:
    """(the tensors' header entries, ``__metadata__`` or None, byte offset
    of the data) of a safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, header.pop("__metadata__", None), 8 + n


class SafeFile:
    """One safetensors file, mapped: ``keys()``, ``metadata()``,
    ``array(name)`` (a numpy view, bf16 as uint16) and ``get(name,
    device)`` (a torch tensor; on the CPU it shares the mapping)."""

    def __init__(self, path):
        self.path = str(path)
        header, self._meta, start = read_header(self.path)
        self._header = header
        size = os.path.getsize(self.path)
        self._buf = (np.memmap(self.path, np.uint8, "c", offset=start)
                     if size > start else np.zeros(0, np.uint8))
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(
                    f"{self.path}: tensor {name!r} has dtype "
                    f"{info['dtype']!r}; this reader takes {sorted(DTYPES)}"
                )
            begin, end = info["data_offsets"]
            want = DTYPES[info["dtype"]][0].itemsize * int(
                np.prod(info["shape"], dtype=np.int64))
            if end - begin != want or end > self._buf.size:
                raise ValueError(
                    f"{self.path}: tensor {name!r} spans bytes "
                    f"[{begin}, {end}), not {want} bytes inside the file"
                )

    def keys(self) -> list[str]:
        return list(self._header)

    def metadata(self) -> Optional[dict]:
        return self._meta

    def array(self, name: str) -> np.ndarray:
        info = self._header[name]
        begin, end = info["data_offsets"]
        np_dtype = DTYPES[info["dtype"]][0]
        raw = self._buf[begin:end]
        if raw.ctypes.data % np_dtype.itemsize:
            raw = raw.copy()  # a writer that did not align this tensor
        return raw.view(np_dtype).reshape(info["shape"])

    def get(self, name: str, device=None) -> torch.Tensor:
        t = torch.from_numpy(self.array(name))
        t = t.view(DTYPES[self._header[name]["dtype"]][1])
        return t if device is None else t.to(device)


def shard_files(path) -> list[pathlib.Path]:
    """The ``*.safetensors`` files of a checkpoint directory, sorted (the
    glob ``tpufw.tools.import_hf`` reads), or ``[path]`` for one file."""
    path = pathlib.Path(path)
    if path.is_file():
        return [path]
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    return files


def open_dir(path) -> dict[str, SafeFile]:
    """{tensor name: the mapped file holding it} over every shard."""
    out: dict[str, SafeFile] = {}
    for f in map(SafeFile, shard_files(path)):
        for k in f.keys():
            if k in out:
                raise ValueError(f"tensor {k!r} is in two shards under {path}")
            out[k] = f
    return out


def load(path, device=None) -> dict[str, torch.Tensor]:
    """Every tensor of a file or directory, moved to ``device`` one by
    one (None: CPU views of the mapping)."""
    return {k: f.get(k, device) for k, f in open_dir(path).items()}


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """The little-endian bytes of a tensor, as a flat uint8 array."""
    if t.dtype not in _NAME_OF:
        raise ValueError(f"safetensors writer: no dtype name for {t.dtype}")
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def save_file(tensors: Mapping[str, torch.Tensor], path,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write one safetensors file; returns the bytes of tensor data. The
    tensors may live on any device: each is copied to the host and
    written before the next. Wider dtypes go first (then by name, as the
    safetensors package orders them), so every tensor is aligned."""
    tensors = dict(sorted(tensors.items(),
                          key=lambda kv: (-kv[1].element_size(), kv[0])))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAME_OF.get(t.dtype, str(t.dtype)),
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-aligned
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(memoryview(_bytes_of(t)))
    os.replace(tmp, path)
    return offset


def plan_shards(sizes: Iterable[tuple[str, int]],
                max_shard_bytes: int = MAX_SHARD_BYTES) -> list[list[str]]:
    """Greedy shard plan in the tensors' order: a shard closes when the
    next tensor would take it past ``max_shard_bytes`` (a larger tensor
    gets a shard of its own), as transformers splits a state dict."""
    shards: list[list[str]] = [[]]
    used = 0
    for name, n in sizes:
        if shards[-1] and used + n > max_shard_bytes:
            shards.append([])
            used = 0
        shards[-1].append(name)
        used += n
    return shards


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir,
                 max_shard_bytes: int = MAX_SHARD_BYTES) -> list[str]:
    """Write ``tensors`` into ``out_dir`` as transformers does: one
    ``model.safetensors`` when it fits a shard, else numbered shards plus
    the index. Returns the file names written."""
    os.makedirs(out_dir, exist_ok=True)
    sizes = [(k, t.numel() * t.element_size()) for k, t in tensors.items()]
    plan = plan_shards(sizes, max_shard_bytes)
    meta = {"format": "pt"}
    if len(plan) == 1:
        save_file(tensors, os.path.join(out_dir, "model.safetensors"), meta)
        return ["model.safetensors"]
    names = [f"model-{i + 1:05d}-of-{len(plan):05d}.safetensors"
             for i in range(len(plan))]
    weight_map = {}
    for fname, keys in zip(names, plan):
        save_file({k: tensors[k] for k in keys},
                  os.path.join(out_dir, fname), meta)
        weight_map.update({k: fname for k in keys})
    index = {"metadata": {"total_size": sum(n for _, n in sizes)},
             "weight_map": weight_map}
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)
    return names + [INDEX_NAME]
