"""Supervised fine-tuning data path (port of ``tpufw.train.sft``): chat
conversations -> packed, assistant-masked batches.

A conversation is rendered through a chat template, encoded span by span
and packed by ``train.data.pack_documents``, whose ``loss_mask`` carries
the per-token train flag. ``loss_mask`` marks TARGET positions
(``trainer.shift_and_mask`` applies ``mask[:, 1:]``), so flagging the
assistant tokens trains exactly the positions whose predicted token lies
in an assistant span: the first response token (predicted from the last
prompt token) and the turn's end-of-turn marker included, nothing else.
Numpy only, as in the JAX package.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tpufw_torch.train.data import pack_documents

#: template name -> (per-role header, turn footer, optional bos text).
#: Strings are rendered around each message's content; the assistant
#: header is part of the PROMPT (not trained), the assistant content +
#: footer are trained.
_TEMPLATES = {
    # Llama-3 instruct header/footer tokens, spelled as text so any
    # tokenizer (incl. the byte fallback) can render them.
    "llama3": {
        "bos": "<|begin_of_text|>",
        "header": "<|start_header_id|>{role}<|end_header_id|>\n\n",
        "footer": "<|eot_id|>",
    },
    "chatml": {
        "bos": "",
        "header": "<|im_start|>{role}\n",
        "footer": "<|im_end|>\n",
    },
    # Dependency-free plain-text template for smoke tests and byte-level
    # tokenizers.
    "plain": {
        "bos": "",
        "header": "### {role}\n",
        "footer": "\n",
    },
}


def render_conversation(
    messages: Sequence[dict], template: str = "plain"
) -> List[Tuple[str, bool]]:
    """Render chat ``messages`` ([{role, content}, ...]) into
    (text_span, train) pairs. Assistant content and its end-of-turn
    footer train; everything else (system and user turns, every header)
    is context only."""
    if template not in _TEMPLATES:
        raise ValueError(
            f"unknown chat template {template!r}; "
            f"expected one of {sorted(_TEMPLATES)}"
        )
    t = _TEMPLATES[template]
    spans: List[Tuple[str, bool]] = []
    if t["bos"]:
        spans.append((t["bos"], False))
    for m in messages:
        role, content = m["role"], m["content"]
        train = role == "assistant"
        spans.append((t["header"].format(role=role), False))
        spans.append((content, train))
        spans.append((t["footer"], train))
    return [(s, tr) for s, tr in spans if s]


def encode_conversation(
    messages: Sequence[dict],
    encode: Callable[[str], List[int]],
    template: str = "plain",
) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, train_mask) for one conversation. ``encode`` must be
    context-free (no special-token injection) — each span is encoded
    independently so the mask boundary is exact."""
    toks: List[int] = []
    mask: List[float] = []
    for text, train in render_conversation(messages, template):
        ids = encode(text)
        toks.extend(ids)
        mask.extend([1.0 if train else 0.0] * len(ids))
    return np.asarray(toks, np.int32), np.asarray(mask, np.float32)


def read_conversations(path: str | pathlib.Path) -> Iterator[list]:
    """JSONL: one conversation per line, either a bare message list or
    {"messages": [...]} — the common export shapes."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            msgs = obj.get("messages") if isinstance(obj, dict) else obj
            if not isinstance(msgs, list) or not all(
                isinstance(m, dict) and "role" in m and "content" in m
                for m in msgs
            ):
                raise ValueError(
                    f"{path}:{ln}: expected a message list "
                    "[{role, content}, ...]"
                )
            yield msgs


def sft_batches(
    path: str | pathlib.Path,
    batch_size: int,
    seq_len: int,
    encode: Callable[[str], List[int]],
    template: str = "plain",
    epochs: Optional[int] = None,
    seed: int = 0,
    drop_untrainable: bool = True,
    shard_id: int = 0,
    num_shards: int = 1,
) -> Iterator[dict]:
    """Packed SFT batches from a JSONL conversation file: shuffled each
    epoch, assistant-masked, segment-separated. ``epochs=None`` cycles
    forever (the trainer's total_steps is the budget).

    ``drop_untrainable`` skips conversations with no assistant turn —
    they would contribute zero loss positions and only dilute batches.

    Multi-process: ``shard_id``/``num_shards`` give each process a
    DISJOINT strided slice of the conversations (same contract as
    TokenCorpus), sliced BEFORE shuffling so shards stay disjoint in
    every epoch regardless of seed.
    """
    convs = list(read_conversations(path))
    if not convs:
        raise ValueError(f"{path}: no conversations")
    convs = convs[shard_id::num_shards]
    if not convs:
        raise ValueError(
            f"{path}: shard {shard_id}/{num_shards} is empty "
            f"({len(list(read_conversations(path)))} conversations)"
        )
    encoded = [
        encode_conversation(m, encode, template) for m in convs
    ]
    if drop_untrainable:
        kept = [(t, m) for t, m in encoded if m.sum() > 0]
        if not kept:
            raise ValueError(
                f"{path}: no conversation has an assistant turn to "
                "train on"
            )
        encoded = kept
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(encoded))
        yield from pack_documents(
            (encoded[i] for i in order), batch_size, seq_len
        )
        epoch += 1


def byte_encode(text: str) -> List[int]:
    """Dependency-free byte tokenizer (id = utf-8 byte + 1; 0 = pad), the
    convention of ``tools.pack_corpus``."""
    return [b + 1 for b in text.encode("utf-8")]
