"""Contrastive embedding fine-tuning (port of
``tpufw.train.contrastive``): a decoder LM becomes a retrieval encoder.

Two published recipes ride the trunk's ``return_hidden`` output:
E5-Mistral (causal trunk, last-token pooling) and LLM2Vec
(``cfg.causal=False``, a bidirectional trunk, mean pooling; the flash
kernels then run non-causal). The pooled vectors are L2-normalized and
trained with a symmetric in-batch-negative InfoNCE.

Batches are ``[2B, T]`` with the pairs interleaved (row 2i the query,
row 2i+1 its positive document), one forward for both, and a [B, B]
similarity matrix over the global batch: in a gang each rank embeds the
pairs of its batch shard and gathers every rank's pooled vectors with
their gradient (``parallel.group.gather_rows``), so every rank's queries see
every rank's documents as negatives, as in ``tpufw``'s global program.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpufw_torch.parallel.group import gather_rows
from tpufw_torch.train import sharding
from tpufw_torch.train.trainer import (
    LlamaAdamW,
    Trainer,
    batch_to_device,
    forward_with_aux,
    on_mesh,
)


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    # Softmax temperature on cosine similarities (0.02-0.1 typical).
    temperature: float = 0.05
    # "mean" over real tokens (bidirectional, LLM2Vec) or the "last" real
    # token (causal, E5-Mistral).
    pooling: str = "mean"


def pool_embeddings(
    hidden: torch.Tensor, segment_ids: torch.Tensor, mode: str = "mean"
) -> torch.Tensor:
    """[B, T, D] hidden + [B, T] segment ids (0 = padding) -> [B, D].
    "mean": the masked mean over real tokens; "last": the last real
    token's state (rows are right-padded: index n_real - 1)."""
    real = (segment_ids > 0).to(hidden.dtype)
    if mode == "mean":
        n = torch.clamp(real.sum(dim=1, keepdim=True), min=1.0)
        return (hidden * real[..., None]).sum(dim=1) / n
    if mode == "last":
        idx = torch.clamp(real.sum(dim=1).long() - 1, min=0)
        return torch.gather(
            hidden, 1, idx[:, None, None].expand(-1, 1, hidden.shape[-1])
        )[:, 0]
    raise ValueError(f"unknown pooling {mode!r}; 'mean' or 'last'")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def info_nce_loss(
    q: torch.Tensor, d: torch.Tensor, temperature: float = 0.05
) -> tuple[torch.Tensor, dict]:
    """Symmetric in-batch-negative InfoNCE over L2-normalized embeddings.
    q, d: [B, D]; pair i is (q[i], d[i]) and every other row a negative.
    Returns (loss, metrics: accuracy, sim_pos, sim_neg)."""
    q, d = _normalize(q), _normalize(d)
    sim = (q @ d.t()).float() / temperature
    labels = torch.arange(sim.shape[0], device=sim.device)
    # Both directions, query -> document and document -> query.
    loss = 0.5 * (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(),
                                                                 labels))
    diag = torch.diagonal(sim)
    metrics = {
        "accuracy": (sim.argmax(dim=-1) == labels).float().mean(),
        "sim_pos": diag.mean() * temperature,
        "sim_neg": (sim.sum() - diag.sum())
        / max(sim.numel() - sim.shape[0], 1) * temperature,
    }
    return loss, metrics


def read_pairs(path: str | pathlib.Path) -> Iterator[dict]:
    """JSONL retrieval pairs: {"query": <text>, "positive": <text>}."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if not (isinstance(obj, dict)
                    and isinstance(obj.get("query"), str)
                    and isinstance(obj.get("positive"), str)):
                raise ValueError(
                    f"{path}:{ln}: expected "
                    '{"query": str, "positive": str}')
            yield obj


def _fit(toks: List[int], seq_len: int):
    """One row: ``toks`` cut to ``seq_len`` and right-padded (segment 0
    marks the padding)."""
    toks = toks[:seq_len]
    out = np.zeros(seq_len, np.int32)
    seg = np.zeros(seq_len, np.int32)
    out[: len(toks)], seg[: len(toks)] = toks, 1
    return out, seg


def pair_batches(
    path: str | pathlib.Path,
    batch_pairs: int,
    seq_len: int,
    encode: Callable[[str], List[int]],
    epochs: Optional[int] = None,
    seed: int = 0,
    shard_id: int = 0,
    num_shards: int = 1,
) -> Iterator[dict]:
    """[2B, T] batches: row 2i = query i, row 2i+1 = its positive
    (right-padded or cut), pairs sharded before the shuffle and
    reshuffled each epoch; ``epochs=None`` cycles forever."""
    pairs = list(read_pairs(path))
    if not pairs:
        raise ValueError(f"{path}: no pairs")
    pairs = pairs[shard_id::num_shards]
    encoded = [(encode(p["query"]), encode(p["positive"])) for p in pairs]
    if len(encoded) < batch_pairs:
        raise ValueError(
            f"{path}: shard {shard_id}/{num_shards} holds "
            f"{len(encoded)} pairs < batch_pairs={batch_pairs}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(encoded))
        for start in range(0, len(order) - batch_pairs + 1, batch_pairs):
            toks = np.zeros((2 * batch_pairs, seq_len), np.int32)
            seg = np.zeros((2 * batch_pairs, seq_len), np.int32)
            for row, i in enumerate(order[start:start + batch_pairs]):
                qt, dt = encoded[i]
                toks[2 * row], seg[2 * row] = _fit(qt, seq_len)
                toks[2 * row + 1], seg[2 * row + 1] = _fit(dt, seq_len)
            yield {"tokens": toks, "segment_ids": seg}
        epoch += 1


def contrastive_train_step(
    model,
    optimizer: LlamaAdamW,
    batch: dict,
    temperature: float = 0.05,
    pooling: str = "mean",
    norm_fn=None,
) -> dict:
    """One InfoNCE update on a [2B, T] interleaved query/document batch
    of device tensors; returns device tensors {loss, grad_norm, accuracy,
    sim_pos, sim_neg}.

    Under a process group ``batch`` is this rank's pairs of the global
    batch (a sharded model): the pooled vectors of every batch-shard rank
    are gathered first (normalizing a row commutes with gathering it;
    under tensor or expert axes the ranks of one coordinate, each row
    once), so
    the loss and the metrics are the global batch's, the same on every
    rank, and the gradients those of one process on the global batch
    (``sharding.backward_global_mean`` weighs each rank's copy of the
    global loss by its share of the pairs). ``norm_fn``: the clip's
    global norm where parameters are split (``LlamaAdamW.step``)."""
    tokens, seg = batch["tokens"], batch["segment_ids"]
    optimizer.zero_grad()
    hidden, aux = forward_with_aux(model, tokens, seg)
    emb = pool_embeddings(hidden.float(), seg, pooling)
    group = sharding.batch_process_group()
    loss, metrics = info_nce_loss(gather_rows(emb[0::2], group),
                                  gather_rows(emb[1::2], group), temperature)
    pairs = torch.tensor(float(emb.shape[0] // 2), device=emb.device)
    loss = sharding.backward_global_mean(loss + aux, pairs)
    grad_norm = optimizer.step(norm_fn)
    return {"loss": loss.detach(), "grad_norm": grad_norm,
            **{k: v.detach() for k, v in metrics.items()}}


class EmbeddingTrainer(Trainer):
    """``Trainer`` for contrastive embedding fine-tuning; ``run``,
    checkpoints, SIGTERM and the ``Meter`` are inherited.
    ``TrainerConfig.batch_size`` is the ROW count 2B, global in a gang
    (each rank feeds the pairs of its batch shard). ``embed`` and
    ``evaluate_retrieval`` are one-process surfaces, as in ``tpufw``:
    they raise in a gang; resume its checkpoint in one process to embed.
    Under tensor and expert axes the pooled vector is read from the
    replicated hidden states after the last row-parallel exit and the
    final norm, so pooling needs no split."""

    whole_rows = True

    def __init__(self, model_cfg, trainer_cfg, mesh_cfg=None, device=None,
                 contrastive: ContrastiveConfig = ContrastiveConfig(),
                 groups=()):
        super().__init__(model_cfg, trainer_cfg, mesh_cfg, device, groups)
        if trainer_cfg.batch_size % 2:
            raise ValueError(
                f"embedding batch_size is the ROW count 2B; got odd "
                f"{trainer_cfg.batch_size}")
        if trainer_cfg.grad_accum != 1:
            raise NotImplementedError(
                "contrastive training does not implement grad_accum: "
                "in-batch negatives are the objective, and microbatching "
                "would shrink the negative pool, changing the loss")
        if contrastive.pooling not in ("mean", "last"):
            raise ValueError(f"unknown pooling {contrastive.pooling!r}")
        self.contrastive = contrastive

    def evaluate(self, data, n_batches=None):
        raise NotImplementedError(
            "EmbeddingTrainer.evaluate would run the LM cross-entropy on "
            "retrieval pairs, which means nothing; use evaluate_retrieval "
            "(recall@k over held-out pairs) instead")

    @on_mesh
    def train_step(self, batch: dict) -> dict:
        out = contrastive_train_step(
            self.model, self.optimizer, batch_to_device(batch, self.device),
            temperature=self.contrastive.temperature,
            pooling=self.contrastive.pooling, norm_fn=self._norm_fn(),
        )
        self.step += 1
        return out

    def evaluate_retrieval(
        self,
        pairs,
        encode: Callable[[str], List[int]],
        seq_len: Optional[int] = None,
        ks: tuple = (1, 5, 10),
        batch_rows: int = 64,
    ) -> dict:
        """Held-out retrieval: every query scored against every document
        of ``pairs`` (an iterable of {"query", "positive"} dicts or a
        JSONL path). Returns {"recall@k": ..., "mrr": ..., "n": N}; rows
        are embedded ``batch_rows`` at a time."""
        if isinstance(pairs, (str, pathlib.Path)):
            pairs = list(read_pairs(pairs))
        else:
            pairs = list(pairs)
        if not pairs:
            raise ValueError("evaluate_retrieval: no pairs")
        t = seq_len or self.cfg.seq_len
        n = len(pairs)
        toks = np.zeros((2 * n, t), np.int32)
        seg = np.zeros_like(toks)
        for i, p in enumerate(pairs):
            toks[i], seg[i] = _fit(encode(p["query"]), t)
            toks[n + i], seg[n + i] = _fit(encode(p["positive"]), t)
        embs = np.concatenate([
            self.embed(toks[s: s + batch_rows], seg[s: s + batch_rows])
            for s in range(0, 2 * n, batch_rows)
        ])
        q, d = embs[:n], embs[n:]
        sim = q @ d.T
        # Rank of the true document for each query (0 = top).
        order = np.argsort(-sim, axis=1)
        ranks = np.argmax(order == np.arange(n)[:, None], axis=1)
        out = {f"recall@{k}": float((ranks < k).mean()) for k in ks}
        out["mrr"] = float((1.0 / (ranks + 1)).mean())
        out["n"] = n
        return out

    @torch.no_grad()
    def embed(self, tokens: np.ndarray, segment_ids: np.ndarray) -> np.ndarray:
        """[N, T] -> [N, D] L2-normalized fp32 embeddings with the
        trainer's pooling: the fine-tuned encoder's inference surface, in
        one process (NotImplementedError in a gang)."""
        if self.model is None:
            raise RuntimeError("embed() before init_state()/restore")
        if self.gang:
            raise NotImplementedError(
                "embed() and evaluate_retrieval() run in one process: "
                "resume the gang's checkpoint in one process to embed")
        b = batch_to_device({"tokens": tokens, "segment_ids": segment_ids},
                            self.device)
        hidden, _ = forward_with_aux(self.model, b["tokens"], b["segment_ids"])
        emb = pool_embeddings(hidden.float(), b["segment_ids"],
                              self.contrastive.pooling)
        return _normalize(emb).cpu().numpy()
