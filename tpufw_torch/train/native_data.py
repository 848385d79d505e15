"""Native token-corpus loader (port of ``tpufw.train.native_data``): ctypes
over ``libtpufwdata``, the repo's C++ packer (``native/dataloader``).

The packer walks a mapped corpus and fills preallocated numpy buffers, so
the per-document packing loop never runs in Python. The library is built
from the repo's source at first use (``ops._build.data_library_path``,
``g++`` into ``build-torch/``); ``TPUFWDATA_LIB`` names a library to use
instead. Unlike the JAX package, a library that cannot be built or loaded
raises: the pure-Python packer (``train.data.pack_documents``) runs only
when the caller passes ``native=False``. With ``shuffle=False`` the two are
bit-identical; with ``shuffle=True`` their permutations differ (splitmix64
against numpy), as in the JAX package.

Corpus layout (<prefix>.bin / <prefix>.idx) is documented in
``native/dataloader/dataloader.h``; ``write_token_corpus`` writes it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from tpufw_torch.train.data import pack_documents

_LIBS: dict[str, ctypes.CDLL] = {}


def write_token_corpus(
    prefix: str, docs: Sequence[Sequence[int]]
) -> tuple[str, str]:
    """Write docs as <prefix>.bin (uint32 tokens) + <prefix>.idx (uint64
    doc-start offsets, n_docs+1 entries). Returns the two paths."""
    bin_path, idx_path = prefix + ".bin", prefix + ".idx"
    offsets = [0]
    with open(bin_path, "wb") as f:
        for d in docs:
            arr = np.asarray(d, np.uint32)
            f.write(arr.tobytes())
            offsets.append(offsets[-1] + arr.size)
    np.asarray(offsets, np.uint64).tofile(idx_path)
    return bin_path, idx_path


def load_library(path: Optional[str] = None) -> ctypes.CDLL:
    """``libtpufwdata`` from ``path``, else ``TPUFWDATA_LIB``, else built
    from the repo's source; raises when it cannot be built or loaded."""
    if path is None:
        path = os.environ.get("TPUFWDATA_LIB")
    if path is None:
        from tpufw_torch.ops._build import data_library_path

        path = str(data_library_path())
    path = os.path.abspath(path)
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    if not os.path.exists(path):
        raise FileNotFoundError(f"libtpufwdata: no library at {path}")
    lib = ctypes.CDLL(path)
    lib.tpufwdata_open.restype = ctypes.c_void_p
    lib.tpufwdata_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tpufwdata_close.argtypes = [ctypes.c_void_p]
    lib.tpufwdata_error.restype = ctypes.c_char_p
    lib.tpufwdata_n_docs.restype = ctypes.c_uint64
    lib.tpufwdata_n_docs.argtypes = [ctypes.c_void_p]
    lib.tpufwdata_n_tokens.restype = ctypes.c_uint64
    lib.tpufwdata_n_tokens.argtypes = [ctypes.c_void_p]
    lib.tpufwdata_begin_epoch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.tpufwdata_next_batch.restype = ctypes.c_int
    lib.tpufwdata_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    _LIBS[path] = lib
    return lib


class TokenCorpus:
    """Iterator factory over a packed token corpus.

    ``epochs=None`` streams forever (reshuffling per epoch when
    ``shuffle``); an integer stops after that many passes. ``shard_id`` of
    ``num_shards`` takes a disjoint round-robin subset of the (shuffled)
    document order. ``native=False`` packs in Python; otherwise the
    library (``lib_path``, see ``load_library``) must load.
    """

    def __init__(
        self,
        prefix: str,
        batch_size: int,
        seq_len: int,
        shuffle: bool = False,
        seed: int = 0,
        epochs: Optional[int] = None,
        lib_path: Optional[str] = None,
        shard_id: int = 0,
        num_shards: int = 1,
        native: bool = True,
    ):
        self.prefix = prefix
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shuffle = shuffle
        self.seed = seed
        self.epochs = epochs
        if not (0 <= shard_id < num_shards):
            raise ValueError(
                f"shard_id {shard_id} out of range for {num_shards} shards"
            )
        if num_shards > 1 and epochs is not None:
            # Round-robin doc shards hold unequal token counts, so finite
            # epochs would end at different batch counts per process.
            raise ValueError(
                "num_shards > 1 requires epochs=None (stream + stop by "
                "trainer total_steps): finite epochs yield unequal batch "
                "counts across shards and deadlock multi-process gangs"
            )
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._lib = load_library(lib_path) if native else None

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __iter__(self) -> Iterator[dict]:
        if self._lib is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_python()

    def _iter_native(self) -> Iterator[dict]:
        lib = self._lib
        handle = lib.tpufwdata_open(
            (self.prefix + ".bin").encode(), (self.prefix + ".idx").encode()
        )
        if not handle:
            raise FileNotFoundError(
                f"tpufwdata_open({self.prefix}): "
                f"{lib.tpufwdata_error().decode()}"
            )
        try:
            epoch = 0
            while self.epochs is None or epoch < self.epochs:
                lib.tpufwdata_begin_epoch(
                    handle, int(self.shuffle), self.seed, epoch,
                    self.shard_id, self.num_shards,
                )
                while True:
                    toks = np.empty((self.batch_size, self.seq_len), np.int32)
                    segs = np.empty_like(toks)
                    mask = np.empty((self.batch_size, self.seq_len),
                                    np.float32)
                    ok = lib.tpufwdata_next_batch(
                        handle, self.batch_size, self.seq_len,
                        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    )
                    if not ok:
                        break
                    yield {"tokens": toks, "segment_ids": segs,
                           "loss_mask": mask}
                epoch += 1
        finally:
            lib.tpufwdata_close(handle)

    def _docs(self, epoch: int) -> Iterator[np.ndarray]:
        tokens = np.memmap(self.prefix + ".bin", np.uint32, "r")
        offsets = np.fromfile(self.prefix + ".idx", np.uint64)
        order = np.arange(len(offsets) - 1)
        if self.shuffle:
            # numpy's permutation, not the library's splitmix64 one.
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        order = order[self.shard_id::self.num_shards]
        for d in order:
            yield np.asarray(
                tokens[int(offsets[d]):int(offsets[d + 1])], np.int32
            )

    def _iter_python(self) -> Iterator[dict]:
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            yield from pack_documents(
                self._docs(epoch), self.batch_size, self.seq_len
            )
            epoch += 1
