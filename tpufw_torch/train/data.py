"""Input pipelines: synthetic LM batches and packed token streams.

A copy of ``tpufw.train.data`` (numpy only), kept in the port so that both
packages yield byte-identical batches for the same seed without the port
importing the JAX package. Batches are numpy arrays; the trainer moves
them to the device.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def synthetic_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    n_batches: Optional[int] = None,
) -> Iterator[dict]:
    """Deterministic random-token batches, generated host-side with numpy so
    device compute is purely the model (what a benchmark wants)."""
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        yield {
            "tokens": rng.integers(
                0, vocab_size, (batch_size, seq_len), dtype=np.int32
            )
        }
        i += 1


def synthetic_packed_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    mean_doc_len: int = 512,
    n_batches: Optional[int] = None,
) -> Iterator[dict]:
    """Synthetic PACKED batches: random docs of geometric length packed via
    ``pack_documents`` — the production data shape (segment_ids +
    loss_mask) without IO, so the bench can measure the packed/flash path
    (VERDICT r1 item 2: the measured number and the production path must
    not diverge)."""
    rng = np.random.default_rng(seed)

    def docs():
        while True:
            n = 1 + min(rng.geometric(1.0 / mean_doc_len), 4 * mean_doc_len)
            yield rng.integers(0, vocab_size, (n,), dtype=np.int32)

    it = pack_documents(docs(), batch_size, seq_len)
    for i, batch in enumerate(it):
        if n_batches is not None and i >= n_batches:
            break
        yield batch


def _emit(batch_toks: list, batch_segs: list, batch_train: list) -> dict:
    segs = np.array(batch_segs, np.int32)
    return {
        "tokens": np.array(batch_toks, np.int32),
        "segment_ids": segs,
        "loss_mask": (
            (segs > 0).astype(np.float32)
            * np.array(batch_train, np.float32)
        ),
    }


def pack_documents(
    docs: Iterator,
    batch_size: int,
    seq_len: int,
    pad_id: int = 0,
) -> Iterator[dict]:
    """Pack variable-length token docs into fixed [B, T] batches.

    Emits ``tokens``, ``segment_ids`` (per-doc ids so attention can't cross
    documents — wired to the model's segment masking), and ``loss_mask``
    (0 on padding). Documents longer than T are split; no tokens dropped.

    ``docs`` yields token arrays, or ``(tokens, train_mask)`` pairs for
    objectives that train on a SUBSET of each document's positions (SFT:
    assistant turns only — tpufw.train.sft); the per-token mask rides
    the packing with its tokens and lands in ``loss_mask``.
    """
    row_tokens: list[int] = []
    row_segs: list[int] = []
    row_train: list[float] = []
    seg = 1
    batch_toks, batch_segs, batch_train = [], [], []

    def flush_row():
        nonlocal row_tokens, row_segs, row_train, seg
        pad = seq_len - len(row_tokens)
        batch_toks.append(row_tokens + [pad_id] * pad)
        batch_segs.append(row_segs + [0] * pad)
        batch_train.append(row_train + [0.0] * pad)
        row_tokens, row_segs, row_train = [], [], []
        seg = 1

    for doc in docs:
        if isinstance(doc, tuple):
            doc, train = doc
            train = list(np.asarray(train, np.float32))
        else:
            train = None
        doc = list(np.asarray(doc, dtype=np.int32))
        if train is None:
            train = [1.0] * len(doc)
        elif len(train) != len(doc):
            raise ValueError(
                f"train_mask length {len(train)} != doc length {len(doc)}"
            )
        while doc:
            space = seq_len - len(row_tokens)
            take, doc = doc[:space], doc[space:]
            row_tokens.extend(take)
            row_train.extend(train[:space])
            train = train[space:]
            row_segs.extend([seg] * len(take))
            seg += 1
            if len(row_tokens) == seq_len:
                flush_row()
            if len(batch_toks) == batch_size:
                yield _emit(batch_toks, batch_segs, batch_train)
                batch_toks, batch_segs, batch_train = [], [], []
    if row_tokens:
        flush_row()
    if batch_toks:
        while len(batch_toks) < batch_size:
            batch_toks.append([pad_id] * seq_len)
            batch_segs.append([0] * seq_len)
            batch_train.append([0.0] * seq_len)
        yield _emit(batch_toks, batch_segs, batch_train)
