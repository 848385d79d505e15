"""Paged KV pool: a page arena + per-slot page tables (port of
``tpufw.infer.pages``).

The contiguous ``SlotPool`` charges every occupied slot a full
``[cache_len]`` KV row, so device memory caps the rows in flight, and
identical prompt prefixes are prefilled and stored once PER ROW. Here KV
lives in one arena of ``n_pages`` pages of ``page`` slots per layer:

- the MODEL owns the paged read and write (``Attention._paged_cached_attention``
  on a ``PagedKVCache``), so ``SlotPool.decode_steps`` is reused as is;
- this module moves rows in and out: ``insert_paged`` scatters a B=1
  contiguous prefilled row into the slot's pages; ``release_slot`` zeroes
  the slot's table row (stale writes of a done-but-stepped row then land
  in reserved page 0, never in a page handed out again) and returns the
  pages to the host-side ``PageAllocator``;
- prefix sharing rides on top: ``PrefixCache`` maps full-page token
  chunks to resident pages, ``prefill_shared`` gathers the shared pages
  into a fresh row cache and prefills ONLY the suffix. Only full pages
  strictly before the row's first write slot are shared, so copy-on-write
  is structural: divergence lands in private pages.

int8 KV (``kv_quant="int8"``): the arenas are int8 with fp32 per-token
scales stored page-structured ``[n_pages, page]``. Decode tokens are
quantized inside the model at the append; prompt tokens are quantized
here at insert (prefill runs full precision through the row cache).

Chunked prefill (``start_chunked``, ``chunk_step``, ``finalize_chunked``,
``abandon_chunked``): a long prompt runs through its contiguous row cache
one page-aligned chunk per call, each chunk's window is scattered into
its arena pages right away (quantized per token for int8 KV), and the
completed full pages are checkpointed into the prefix trie after every
chunk, so an abandoned prefill resumes from them.

Spill (``trie_spill``/``trie_restore``, wired by
``tpufw_torch.serve.bundle.attach_spill``): a trie page evicted under
arena pressure is exported raw (``export_pages_state``: int8 codes and
page-structured scales as stored) to the host spill tier, and a later
prompt whose resident match ends where a spilled path continues gets its
pages scattered back (``import_pages``) and re-adopted by the trie, so
spill -> restore is bit-equal storage. The page state travels in
``tpufw``'s bundle layout (its cache tree's leaf paths: layers stacked, or
one leaf per layer for a config whose tree is unscanned), so a page
spilled by either package restores in the other. The pool takes a Llama
family model (``PagedKVCache``: K and V) or a DeepSeek one
(``PagedLatentCache``: the ckv and kpe latents) alike.

Migration (``export_slot``/``splice_slot``, driven by
``tpufw_torch.serve.roles``): a live slot's pages and cursors leave one
pool as a bundle state in the same layout and enter another pool's
freshly allocated pages under a new table row, so a slot moves between
replicas, and between the two packages, with its storage bit-equal.

The pool's length, page size and arena belong to its cache
(``Llama.init_paged_cache``); the model's weights are shared with every
other pool, and a draft pool may draw its page ids from the target's
allocator (``create_paged(allocator=)``) into an arena of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpufw_torch.infer.generate import _on
from tpufw_torch.infer.prefix import PrefixCache
from tpufw_torch.infer.sampling import sample_token, track_seen
from tpufw_torch.infer.slots import SlotPool
from tpufw_torch.ops.quant import dequantize_kv, quantize_kv


# Leaf paths of ``tpufw``'s scanned tree (every layer stacked on one
# leading axis) and of its unscanned twin (one leaf per layer).
_SCANNED_PATH = "['cache']['layers']['attn']['{}']"
_LAYER_PATH = "['cache']['layer_{}']['attn']['{}']"


def _is_int8(cache) -> bool:
    """Whether a paged cache layer holds int8 codes (and their scales)."""
    return getattr(cache, cache.FEATS[0] + "_scale") is not None


def _bundle_leaves(cache) -> List[Tuple[str, str]]:
    """(leaf name in ``tpufw``'s cache tree, cache attribute) of the
    leaves of one paged layer that travel in a bundle, in ``tpufw``'s
    flattened (sorted) order: each feature (``PagedKVCache``'s key and
    value, ``PagedLatentCache``'s ckv and kpe), its scales with an int8
    arena, and the segment ids."""
    leaves = [("cached_segment_ids", "seg")]
    for f in cache.FEATS:
        leaves.append((f"cached_{f}", f))
        if _is_int8(cache):
            leaves.append((f"cached_{f}_scale", f"{f}_scale"))
    return sorted(leaves)


def _wire_array(t: torch.Tensor):
    """(numpy array, wire dtype name) of a host tensor; bf16 travels as
    its raw 16-bit patterns (numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def _from_wire(a, name: str) -> torch.Tensor:
    """The host tensor of a bundle array (``_wire_array``'s inverse; an
    ml_dtypes bfloat16 array is read the same way)."""
    # A decoded bundle's arrays are read-only views of its bytes.
    a = np.require(a, requirements=["C", "W"])
    if name == "bfloat16" or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class PageAllocator:
    """Host-side free list + refcounts over the page arena (a copy of
    ``tpufw``'s).

    Page 0 is reserved (the causally masked junk sink unmapped table
    entries point at) and never enters the free list. A page is free
    iff its row refcount is 0 AND the prefix trie does not hold it."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"kv_pages={n_pages}: need >= 2 (page 0 is reserved)"
            )
        self.n_pages = int(n_pages)
        # LIFO free list: recently freed pages are used again first.
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.refs: Dict[int, int] = {}
        self.held: set = set()
        self.freed_total = 0
        # Most pages ever in use at once (row references and trie holds).
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def in_use(self) -> int:
        return self.capacity - len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` free pages with refcount 1, or None (all or
        nothing: a partial grab would deadlock two part-admitted
        rows)."""
        if n > len(self.free):
            return None
        ids = [self.free.pop() for _ in range(n)]
        for i in ids:
            self.refs[i] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    def ref(self, ids: Sequence[int]) -> None:
        for i in ids:
            self.refs[i] = self.refs.get(i, 0) + 1

    def release(self, ids: Sequence[int]) -> int:
        """Drop one row reference per id; free those that hit 0 and are
        not trie-held. Returns the number actually freed."""
        freed = 0
        for i in ids:
            r = self.refs.get(i, 0) - 1
            if r > 0:
                self.refs[i] = r
            else:
                self.refs.pop(i, None)
                if i not in self.held:
                    self.free.append(i)
                    freed += 1
        self.freed_total += freed
        return freed

    def hold(self, ids: Sequence[int]) -> None:
        self.held.update(int(i) for i in ids)

    def drop(self, ids: Sequence[int]) -> int:
        """Trie eviction path: drop the hold; free ids no row uses."""
        freed = 0
        for i in ids:
            self.held.discard(i)
            if self.refs.get(i, 0) == 0:
                self.free.append(i)
                freed += 1
        self.freed_total += freed
        return freed


@dataclasses.dataclass
class ChunkedPrefill:
    """Host-side cursor of one in-flight chunked prefill: the prompt, its
    contiguous row cache mid-flight, the pages committed so far, and the
    generator the final chunk samples the first token with. Created by
    ``PagedSlotPool.start_chunked``, advanced by ``chunk_step``, consumed
    by ``finalize_chunked`` (or ``abandon_chunked`` on preemption: the
    trie checkpoint keeps every completed full page, so a re-admission
    resumes instead of restarting)."""

    prompt: List[int]
    generator: Any
    chunk_pages: int
    n_total: int  # pages the finished row owns (decode budget included)
    row_cache: Any  # None until the first chunk_step attaches it
    seen_row: Any
    cursor: int  # logical slots committed so far
    page_ids: List[int]
    shared_n: int  # trie-shared pages attached at start
    n_chunks: int = 0
    first: Any = None
    first_int: int = -1
    done0: bool = False

    @property
    def resumed(self) -> bool:
        return self.shared_n > 0

    @property
    def deficit(self) -> int:
        """Pages still to acquire before this prefill can finish;
        admission sums it over the in-flight prefills so two
        part-admitted rows never deadlock on the arena."""
        return self.n_total - len(self.page_ids)


@dataclasses.dataclass
class PagedSlotPool(SlotPool):
    """``SlotPool`` whose KV lives in a shared page arena.

    ``decode_steps`` is inherited unchanged: paging is internal to the
    model's cached attention. Insert and retire are replaced by
    page-aware versions, and two host-side owners ride along:
    ``allocator`` (free list + refcounts) and ``prefix`` (radix trie;
    None when prefix caching is off). Prefill runs through a contiguous
    row cache of the pool's length on the same model."""

    page: int = 0
    allocator: Any = None
    prefix: Any = None
    slot_pages: Any = None  # per-slot page ids this row references
    # Spill-tier callbacks (``serve.bundle.attach_spill``; None = no
    # spill): trie_spill(path_tokens, state) receives an evicted trie
    # page's export state; trie_restore(path_tokens) -> state or None
    # CONSUMES the matching spill entry.
    trie_spill: Any = None
    trie_restore: Any = None
    # Admission outcomes: requests whose trie match (spill restores
    # included) covered >= 1 page vs not; pages moved across the device
    # <-> spill boundary.
    prefix_hits: int = 0
    prefix_misses: int = 0
    spill_pages_out: int = 0
    spill_pages_in: int = 0

    @classmethod
    def create_paged(
        cls,
        model,
        n_slots: int,
        *,
        cache_len: int,
        page: int,
        n_pages: Optional[int] = None,
        kv_quant: str = "",
        sampling,
        pad_id: int = 0,
        eos_id: Optional[int] = None,
        prefix_cache: bool = True,
        allocator: Optional[PageAllocator] = None,
    ) -> "PagedSlotPool":
        """A pool of ``n_slots`` rows of ``cache_len`` logical slots over
        an arena of ``n_pages`` pages of ``page`` slots; the default
        arena holds exactly ``n_slots`` full rows plus page 0, the same
        memory as the contiguous pool it replaces. ``allocator`` shares
        another pool's page-id space (a speculative draft pool riding the
        target's page budget): the two arenas are separate, so they must
        have the same number of pages."""
        if n_pages is None:
            n_pages = n_slots * (cache_len // page) + 1
        if allocator is not None and allocator.n_pages != int(n_pages):
            raise ValueError(
                f"shared allocator covers {allocator.n_pages} pages but "
                f"the arena has {n_pages}"
            )
        dev = model.device
        seen = None
        if track_seen(sampling):
            seen = torch.zeros(
                n_slots, model.cfg.vocab_size, dtype=torch.bool, device=dev
            )
        return cls(
            model=model,
            n_slots=n_slots,
            sampling=sampling,
            pad_id=pad_id,
            eos_id=eos_id,
            cache=model.init_paged_cache(
                n_slots, cache_len, page, n_pages, kv_quant
            ),
            token=torch.zeros(n_slots, dtype=torch.long, device=dev),
            pos=torch.zeros(n_slots, dtype=torch.long, device=dev),
            done=torch.ones(n_slots, dtype=torch.bool, device=dev),
            remaining=torch.zeros(n_slots, dtype=torch.long, device=dev),
            seen=seen,
            page=int(page),
            allocator=(
                PageAllocator(int(n_pages)) if allocator is None
                else allocator
            ),
            prefix=PrefixCache(int(page)) if prefix_cache else None,
            slot_pages=[[] for _ in range(n_slots)],
        )

    @property
    def cache_len(self) -> int:
        return int(self.cache[0].length)

    # ---- host-side page bookkeeping -------------------------------

    @property
    def per_row(self) -> int:
        return self.cache_len // self.page

    def n_pages_for(self, need: int) -> int:
        """Pages covering ``need`` logical slots (= prompt_len +
        max_new - 1: a live row's cursor never passes its budget)."""
        return -(-need // self.page)

    def acquire_pages(
        self, prompt: Sequence[int], need: int
    ) -> Optional[Tuple[List[int], int]]:
        """Reserve pages for a row: match the prompt against the prefix
        trie, then allocate the rest, evicting refcount-0 trie leaves
        under pressure. Returns (page_ids, shared_n) with row refs taken
        on every id, or None if the arena cannot fit the row now (the
        scheduler retries after the next retire)."""
        p = len(prompt)
        n_total = self.n_pages_for(need)
        shared: List[int] = []
        if self.prefix is not None and p > 1:
            # At least one suffix token must remain: the first output
            # token's logits need a real forward pass.
            shared = self.prefix.match(prompt)[: (p - 1) // self.page]
        # Reference the shared pages FIRST so the eviction below cannot
        # free them (a page only the trie holds has refcount 0).
        self.allocator.ref(shared)
        try:
            # Where the resident match ends, the spill tier may still
            # hold the next chunks: restore them before prefilling.
            self._extend_shared_from_spill(
                prompt, shared, (p - 1) // self.page
            )
            ids = self._alloc_evicting(n_total - len(shared))
        except BaseException:
            # ``shared`` grew in place: restored pages release too (the
            # trie's hold keeps them resident).
            self.allocator.release(shared)
            raise
        if ids is None:
            self.allocator.release(shared)
            return None
        if self.prefix is not None and p > 1:
            if shared:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1
        return shared + ids, len(shared)

    def release_pages(self, ids: Sequence[int]) -> int:
        return self.allocator.release(ids)

    def register_prefix(
        self, prompt: Sequence[int], page_ids: Sequence[int]
    ) -> None:
        """Adopt the row's FULL prompt pages into the trie (a partial
        trailing page and the decode pages stay private: they are the
        copy-on-write divergence zone)."""
        if self.prefix is None:
            return
        n_full = len(prompt) // self.page
        adopted = self.prefix.insert(prompt, list(page_ids)[:n_full])
        self.allocator.hold(adopted)

    # ---- spill tier -----------------------------------------------

    def _spill_hook(self):
        """``on_evict`` callback for ``PrefixCache.evict``: export each
        victim page to the spill tier while its arena content is still
        valid. Best-effort: a failed spill degrades to a plain eviction
        and never breaks an admission."""
        if self.trie_spill is None:
            return None

        def cb(path_tokens, page_id):
            try:
                state = self.export_pages_state([page_id])
                self.trie_spill(tuple(path_tokens), state)
                self.spill_pages_out += 1
            except Exception:  # noqa: BLE001 — best-effort spill
                pass

        return cb

    def _bundle_leaves(self) -> List[Tuple[str, str]]:
        return _bundle_leaves(self.cache[0])

    def _layer_order(self) -> Optional[List[int]]:
        """None when bundles take ``tpufw``'s scanned paths; else the
        layers in the order ``tpufw`` flattens its unscanned tree
        (``layer_10`` sorts before ``layer_2``), for a config whose
        ``tpufw`` tree is unscanned (``scan_layers=False``: DeepSeek with
        leading dense layers)."""
        if getattr(self.model.cfg, "scan_layers", True):
            return None
        return sorted(range(len(self.cache)), key=lambda i: f"layer_{i}")

    def _wire_leaves(self, stacked) -> Tuple[list, list, list]:
        """(paths, arrays, dtype names) of host tensors [layers, n, page,
        ...], one per bundle leaf, in this model's ``tpufw`` layout."""
        leaves = self._bundle_leaves()
        order = self._layer_order()
        paths, arrays, dtypes = [], [], []

        def put(path, t):
            a, dt = _wire_array(t)
            paths.append(path)
            arrays.append(a)
            dtypes.append(dt)

        if order is None:
            for (name, _), t in zip(leaves, stacked):
                put(_SCANNED_PATH.format(name), t)
        else:
            for i in order:
                for (name, _), t in zip(leaves, stacked):
                    put(_LAYER_PATH.format(i, name), t[i:i + 1])
        return paths, arrays, dtypes

    @torch.no_grad()
    def export_pages_state(self, ids: Sequence[int]) -> Dict[str, Any]:
        """Snapshot arena pages ``ids`` (no slot attached) as a bundle
        state dict, ``tpufw``'s trie-spill serialization: every layer's
        K, V and segment ids (and, for int8, the codes' fp32 scales) RAW,
        stacked over layers under the scanned tree's leaf paths. Cursors
        are zeroed placeholders that fill the bundle's required header
        fields; ``import_pages`` ignores them."""
        idx = _on(self.model, [int(i) for i in ids])
        paths, arrays, dtypes = self._wire_leaves([
            torch.stack([getattr(c, attr)[idx] for c in self.cache]).cpu()
            for _, attr in self._bundle_leaves()
        ])
        return {
            "page": self.page,
            "kv_quant": "int8" if _is_int8(self.cache[0]) else "",
            "n_pages": len(ids),
            "paths": paths,
            "arrays": arrays,
            "dtypes": dtypes,
            "token": 0, "pos": 0, "remaining": 0, "done": True,
            "cache_index": 0, "seen": None,
        }

    @torch.no_grad()
    def export_slot(
        self, slot: int, page_ids: Optional[Sequence[int]] = None
    ) -> Dict[str, Any]:
        """Snapshot slot ``slot``'s pages and cursors as a migration state
        (``tpufw_torch.serve.bundle`` serializes it): the pages as
        ``export_pages_state`` stores them (int8 codes and fp32 scales
        raw), plus ``token``, ``pos``, ``remaining``, ``done``,
        ``cache_index`` and the ``seen`` row.

        MUST run before ``release_slot``: after it the table row is zeroed
        and the pages may belong to another admission. ``page_ids`` is the
        caller's snapshot of the row's pages (the scheduler passes the one
        it took when the chunk launched). The pages of every leaf and
        layer and the cursors are gathered into one device buffer that
        reaches the host in one copy."""
        ids = list(self.slot_pages[slot] if page_ids is None else page_ids)
        dev = self.token.device
        idx = torch.tensor(ids, dtype=torch.long, device=dev)
        leaves = self._bundle_leaves()
        n_layers = len(self.cache)
        # The staging buffer's regions: one per leaf [layers, n, page,
        # ...], then the five cursors, then the seen row. Each starts on a
        # 16-byte boundary so it can be viewed in its own dtype.
        specs = [((n_layers, len(ids)) + tuple(getattr(self.cache[0],
                                                       attr).shape[1:]),
                  getattr(self.cache[0], attr).dtype)
                 for _, attr in leaves]
        specs.append(((5,), torch.long))
        if self.seen is not None:
            specs.append((tuple(self.seen.shape[1:]), torch.uint8))
        offsets, total = [], 0
        for shape, dtype in specs:
            offsets.append(total)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            total += -(-nbytes // 16) * 16
        buf = torch.empty(total, dtype=torch.uint8, device=dev)

        def region(i):
            shape, dtype = specs[i]
            n = int(np.prod(shape)) * dtype.itemsize
            return buf[offsets[i]:offsets[i] + n].view(dtype).view(shape)

        for i, (_, attr) in enumerate(leaves):
            dst = region(i)
            for layer, c in enumerate(self.cache):
                torch.index_select(getattr(c, attr), 0, idx, out=dst[layer])
        region(len(leaves)).copy_(torch.stack([
            self.token[slot], self.pos[slot], self.remaining[slot],
            self.done[slot].long(), self.cache[0].index[slot].long(),
        ]))
        if self.seen is not None:
            region(len(leaves) + 1).copy_(self.seen[slot])
        buf = buf.cpu()  # the one host copy
        paths, arrays, dtypes = self._wire_leaves(
            [region(i) for i in range(len(leaves))])
        token, pos, remaining, done, cache_index = region(len(leaves)).tolist()
        seen = None
        if self.seen is not None:
            seen = region(len(leaves) + 1).numpy().astype(bool)
        return {
            "page": self.page,
            "kv_quant": "int8" if _is_int8(self.cache[0]) else "",
            "n_pages": len(ids),
            "paths": paths,
            "arrays": arrays,
            "dtypes": dtypes,
            "token": token,
            "pos": pos,
            "remaining": remaining,
            "done": bool(done),
            "cache_index": cache_index,
            "seen": seen,
        }

    def _check_layout(self, state: Dict[str, Any], what: str,
                      n_ids: int, exact: bool) -> List[torch.Tensor]:
        """Check a bundle state against this pool before anything touches
        the arena, and return its page payload as host tensors stacked
        over layers, one per traveling leaf: page size, quant mode, page
        count (``exact``: as many ids as pages; else at least as many),
        and the leaf layout (``tpufw``'s scanned tree, or its unscanned
        twin with one leaf per layer). Raises ValueError."""
        if int(state["page"]) != self.page:
            raise ValueError(
                f"{what} page size {state['page']} != pool page {self.page}"
            )
        kv_quant = "int8" if _is_int8(self.cache[0]) else ""
        if (state.get("kv_quant") or "") != kv_quant:
            raise ValueError(
                f"{what} kv_quant {state.get('kv_quant')!r} != pool "
                f"kv_quant {kv_quant!r}"
            )
        n_pages = int(state["n_pages"])
        if n_ids < n_pages or (exact and n_ids != n_pages):
            raise ValueError(
                f"{what} carries {n_pages} pages but {n_ids} were allocated"
            )
        leaves = self._bundle_leaves()
        n_layers = len(self.cache)
        paths = list(state["paths"])
        arrays = list(state["arrays"])
        names = list(state.get("dtypes") or [a.dtype.name for a in arrays])
        by_path = {p: (a, d) for p, a, d in zip(paths, arrays, names)}
        per_layer = [[_LAYER_PATH.format(i, n) for i in range(n_layers)]
                     for n, _ in leaves]
        if paths == [_SCANNED_PATH.format(n) for n, _ in leaves]:
            stacked = [_from_wire(a, d) for a, d in zip(arrays, names)]
        elif len(paths) == len(by_path) and set(paths) == {
                p for ps in per_layer for p in ps}:
            # One leaf per layer, in any layer order (tpufw flattens
            # layer_10 before layer_2).
            stacked = [torch.cat([_from_wire(*by_path[p]) for p in ps])
                       for ps in per_layer]
        else:
            raise ValueError(
                f"{what} leaf layout does not match this pool (got "
                f"{paths!r})"
            )
        for (_, attr), t in zip(leaves, stacked):
            want = (n_layers, n_pages) + tuple(
                getattr(self.cache[0], attr).shape[1:])
            if tuple(t.shape) != want:
                raise ValueError(
                    f"{what} leaf {attr} has shape {tuple(t.shape)}, the "
                    f"pool wants {want}"
                )
        return stacked

    def _scatter_pages(self, page_ids: Sequence[int], stacked) -> None:
        """Write a checked payload into arena pages ``page_ids``: one
        host-to-device copy and one ``index_copy_`` per leaf and layer."""
        idx = _on(self.model, [int(i) for i in page_ids])
        for (_, attr), t in zip(self._bundle_leaves(), stacked):
            dst0 = getattr(self.cache[0], attr)
            t = t.to(device=dst0.device, dtype=dst0.dtype)
            for i, c in enumerate(self.cache):
                getattr(c, attr).index_copy_(0, idx, t[i])

    @torch.no_grad()
    def splice_slot(
        self, slot: int, state: Dict[str, Any], page_ids: Sequence[int]
    ) -> None:
        """Occupy ``slot`` with a migrated bundle state: scatter its pages
        into ``page_ids`` (already allocated, row refs taken), point the
        slot's table row at every allocated id and restore the cursors.

        Everything is checked before anything is written (page size,
        quant mode, page count, leaf layout, the ``seen`` row on both
        sides or neither) and a mismatch raises ValueError with the arena
        untouched. A bundle from a chunked prefill carries only the
        prompt's pages: the table maps the whole grant, the payload fills
        the pages it carries, and the rest are written by decode before
        the causal mask lets anything read them."""
        stacked = self._check_layout(state, "bundle", len(page_ids),
                                     exact=False)
        seen_row = state.get("seen")
        if (seen_row is None) != (self.seen is None):
            raise ValueError(
                "bundle and pool disagree on repetition-penalty tracking "
                "(seen mask present on one side only)"
            )
        if len(page_ids) > self.per_row:
            raise ValueError(
                f"{len(page_ids)} pages exceed the pool's row of "
                f"{self.per_row}"
            )
        n = int(state["n_pages"])
        self._scatter_pages(list(page_ids)[:n], stacked)
        dev = self.token.device
        table_row = torch.zeros(self.per_row, dtype=torch.long)
        table_row[: len(page_ids)] = torch.tensor(
            [int(i) for i in page_ids], dtype=torch.long)
        self.cache[0].table[slot] = table_row.to(dev)
        for c in self.cache:
            c.index[slot] = int(state["cache_index"])
        self.token[slot] = int(state["token"])
        self.pos[slot] = int(state["pos"])
        self.remaining[slot] = int(state["remaining"])
        self.done[slot] = bool(state["done"])
        if self.seen is not None:
            self.seen[slot] = torch.from_numpy(
                np.asarray(seen_row, dtype=bool)).to(dev)
        self.slot_pages[slot] = list(page_ids)

    @torch.no_grad()
    def import_pages(
        self, page_ids: Sequence[int], state: Dict[str, Any]
    ) -> None:
        """Scatter a bundle's page payload into arena pages ``page_ids``
        (already allocated, exactly as many as it carries): the restore
        half of the spill tier. Checked as ``splice_slot`` checks, before
        anything touches the arena. No cursors, no table row: the pages
        re-enter service through the trie."""
        stacked = self._check_layout(state, "spill bundle", len(page_ids),
                                     exact=True)
        self._scatter_pages(page_ids, stacked)

    def _extend_shared_from_spill(
        self, prompt: Sequence[int], shared: List[int], cap: int
    ) -> None:
        """Extend a trie match chunk by chunk from the spill tier: while
        the NEXT full-page chunk of ``prompt`` has a spill entry, allocate
        one page (its allocation reference IS the row's reference, as
        ``ref(shared)`` is for matched pages), scatter the bytes back and
        re-adopt the path into the trie (held), so later requests hit it
        resident. Mutates ``shared`` in place.

        Best-effort and non-raising: under arena pressure (allocation
        fails) it stops rather than evicting (restoring by evicting would
        churn pages through the tier), and a torn or mismatched entry
        stops the walk; the row prefills the rest."""
        if self.trie_restore is None or self.prefix is None:
            return
        while len(shared) < cap:
            end = (len(shared) + 1) * self.page
            try:
                state = self.trie_restore(
                    tuple(int(t) for t in prompt[:end])
                )
            except Exception:  # noqa: BLE001 — best-effort restore
                return
            if state is None:
                return
            ids = self.allocator.alloc(1)
            if ids is None:
                return
            try:
                self.import_pages(ids, state)
            except Exception:  # noqa: BLE001 — best-effort restore
                self.allocator.release(ids)
                return
            adopted = self.prefix.insert(prompt[:end], shared + ids)
            self.allocator.hold(adopted)
            shared.extend(ids)
            self.spill_pages_in += 1

    # ---- device ops -----------------------------------------------

    @torch.no_grad()
    def insert_paged(
        self,
        slot: int,
        row_cache,
        first,
        pos0: int,
        budget: int,
        page_ids: Sequence[int],
        shared_n: int,
        row_seen=None,
    ) -> None:
        """Occupy ``slot`` with a prefilled contiguous row scattered into
        ``page_ids`` (row refs already taken by ``acquire_pages``); the
        first ``shared_n`` ids are prefix pages attached by reference,
        never written. Every slot of the row's own pages is written (the
        row cache's zeros and segment 0 past its cursor included), so no
        earlier occupant's K/V survives in them."""
        dev = self.token.device
        table_row = torch.zeros(self.per_row, dtype=torch.long)
        table_row[: len(page_ids)] = torch.tensor(
            list(page_ids), dtype=torch.long
        )
        table_row = table_row.to(dev)
        self._scatter_window(row_cache, table_row, shared_n * self.page,
                             len(page_ids) * self.page)
        for pool, row in zip(self.cache, row_cache):
            pool.index[slot] = row.index
        # One table tensor serves every layer.
        self.cache[0].table[slot] = table_row
        self.token[slot] = torch.as_tensor(first).reshape(())
        self.pos[slot] = pos0
        self.done[slot] = False
        self.remaining[slot] = budget
        if self.seen is not None:
            self.seen[slot] = row_seen[0]
        self.slot_pages[slot] = list(page_ids)

    def _scatter_window(self, row_cache, table_row, start, stop) -> None:
        """Write logical slots [start, stop) of the B=1 row cache into the
        pages ``table_row`` maps them to, K/V quantized per token for an
        int8 arena."""
        page = self.page
        idx = torch.arange(start, stop, device=table_row.device)
        phys, off = table_row[idx // page], idx % page
        for pool, row in zip(self.cache, row_cache):
            quant = _is_int8(pool)
            for f in pool.FEATS:
                x = getattr(row, f)[0, start:stop]
                if quant:
                    q, sc = quantize_kv(x, n_feat=x.ndim - 1)
                    getattr(pool, f)[phys, off] = q
                    getattr(pool, f + "_scale")[phys, off] = sc
                else:
                    getattr(pool, f)[phys, off] = x.to(getattr(pool, f).dtype)
            pool.seg[phys, off] = row.seg[0, start:stop]

    @torch.no_grad()
    def _attach_row(self, shared_ids):
        """Fresh B=1 contiguous row cache of the pool's length with
        ``shared_ids``' pages gathered into its first
        ``len(shared_ids) * page`` slots (dequantized for int8: the
        suffix prefill attends in full precision), cursor set after
        them."""
        row = self.model.init_cache(1, length=self.cache_len)
        n = len(shared_ids) * self.page
        if not n:
            return row
        ids = _on(self.model, list(shared_ids))
        for pool, r in zip(self.cache, row):
            for f in pool.FEATS:
                x, dst = getattr(pool, f)[ids], getattr(r, f)
                if _is_int8(pool):
                    x = dequantize_kv(x, getattr(pool, f + "_scale")[ids],
                                      dst.dtype)
                dst[0, :n] = x.reshape(n, *x.shape[2:]).to(dst.dtype)
            r.seg[0, :n] = pool.seg[ids].reshape(n)
            r.index = n
        return row

    @torch.no_grad()
    def prefill_shared(
        self, prompt: Sequence[int], shared_ids,
        generator: Optional[torch.Generator],
    ):
        """Prefix-hit admission: attach ``shared_ids``' pages to a fresh
        row cache and prefill only the suffix, at its true positions and
        slots. The first token draws from ``generator`` exactly as a cold
        ``prefill_row`` of the whole prompt would, so shared and cold
        admissions sample alike. Same return contract as
        ``prefill_row``: (row_cache, first, first_int, done, seen)."""
        row = self._attach_row(shared_ids)
        length = len(shared_ids) * self.page
        suffix = _on(self.model, [list(prompt[length:])])
        t = suffix.shape[1]
        positions = length + torch.arange(t, device=suffix.device)[None, :]
        seg = torch.ones(1, t, dtype=torch.int32, device=suffix.device)
        logits = self.model(suffix, positions, seg, cache=row)
        seen = None
        if track_seen(self.sampling):
            # The repetition penalty's presence mask covers the WHOLE
            # prompt: the shared tokens count though they were not rerun.
            seen = torch.zeros(
                1, logits.shape[-1], dtype=torch.bool, device=suffix.device
            )
            seen[0, _on(self.model, list(prompt))] = True
        first = sample_token(logits[:, -1, :], self.sampling, generator, seen)
        if seen is not None:
            seen[0, first] = True
        done = (
            torch.zeros(1, dtype=torch.bool, device=first.device)
            if self.eos_id is None else first == self.eos_id
        )
        return row, first, int(first[0]), done, seen

    # ---- chunked prefill ------------------------------------------

    def _alloc_evicting(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, evicting refcount-0 trie leaves if the free
        list is short; None if even that does not free enough."""
        ids = self.allocator.alloc(n)
        if ids is None and self.prefix is not None:
            self.prefix.evict(n - self.allocator.n_free, self.allocator,
                              on_evict=self._spill_hook())
            ids = self.allocator.alloc(n)
        return ids

    def start_chunked(
        self, prompt: Sequence[int], need: int,
        generator: Optional[torch.Generator], chunk_pages: int,
    ) -> ChunkedPrefill:
        """Open a chunked prefill: match the prompt against the prefix
        trie (a checkpoint of an abandoned prefill resumes here), take
        row references on the shared pages and return the cursor
        ``chunk_step`` advances. Acquires no new pages (each chunk grabs
        its own) and reads no arena: the shared-prefix attach happens in
        the first ``chunk_step``. ``need`` is the slot count the finished
        row owns pages for (prompt + decode budget + speculative slack);
        ``generator`` is the one a cold prefill of the whole prompt would
        sample the first token with."""
        prompt = [int(t) for t in prompt]
        p = len(prompt)
        shared: List[int] = []
        if self.prefix is not None and p > 1:
            # As acquire_pages: >= 1 suffix token must remain.
            shared = self.prefix.match(prompt)[: (p - 1) // self.page]
        self.allocator.ref(shared)
        try:
            # The spill tier continues the resident match, as in
            # acquire_pages (restored pages join the deferred attach).
            self._extend_shared_from_spill(
                prompt, shared, (p - 1) // self.page
            )
            if self.prefix is not None and p > 1:
                if shared:
                    self.prefix_hits += 1
                else:
                    self.prefix_misses += 1
            seen = None
            if track_seen(self.sampling):
                seen = torch.zeros(1, self.model.cfg.vocab_size,
                                   dtype=torch.bool, device=self.token.device)
                if shared:
                    seen[0, _on(self.model,
                                prompt[: len(shared) * self.page])] = True
            cp = ChunkedPrefill(
                prompt=prompt,
                generator=generator,
                chunk_pages=max(1, int(chunk_pages)),
                n_total=self.n_pages_for(max(need, p)),
                row_cache=None,
                seen_row=seen,
                cursor=len(shared) * self.page,
                page_ids=list(shared),
                shared_n=len(shared),
            )
        except BaseException:
            self.allocator.release(shared)
            raise
        return cp

    @torch.no_grad()
    def chunk_step(self, cp: ChunkedPrefill, unlocked=None) -> str:
        """Advance ``cp`` by one page-aligned chunk. Returns "ran"
        (progress, more chunks to go), "done" (first token sampled, ready
        for ``finalize_chunked``) or "stalled" (the arena cannot supply
        this chunk's pages now; nothing was consumed, retry after the
        next release).

        The chunk runs through the row cache at its true positions and
        slots, attending everything committed before it, and then its
        page-aligned window is scattered into its arena pages (the tail
        of a final, partial page gets the row cache's zeros and segment
        0). The final chunk first acquires every remaining page of the
        row, decode budget included, so a finished prefill can always be
        finalized, and only the final chunk samples. The committed full
        pages are checkpointed into the trie after every chunk.

        ``unlocked``, if given, is a context-manager factory that releases
        the caller's mutex around the device work (attach, forward,
        scatter, sample): the allocator and the trie are touched only
        outside it, so admissions and abandons interleave with a chunk's
        compute. The caller must still keep one ``chunk_step`` in flight
        per pool."""
        page = self.page
        p = len(cp.prompt)
        start = cp.cursor
        left = p - start
        width = min(cp.chunk_pages, -(-left // page)) * page
        n_real = min(left, width)
        is_final = left <= width
        target = cp.n_total if is_final else (start + width) // page
        n_new = target - len(cp.page_ids)
        if n_new > 0:
            ids = self._alloc_evicting(n_new)
            if ids is None:
                return "stalled"
            cp.page_ids.extend(ids)
        page_ids = list(cp.page_ids)
        with (unlocked() if unlocked is not None
              else contextlib.nullcontext()):
            if cp.row_cache is None:
                cp.row_cache = self._attach_row(page_ids[: cp.shared_n])
            dev = self.token.device
            tokens = _on(self.model, [cp.prompt[start:start + n_real]])
            positions = start + torch.arange(n_real, device=dev)[None, :]
            seg = torch.ones(1, n_real, dtype=torch.int32, device=dev)
            logits = self.model(tokens, positions, seg, cache=cp.row_cache)
            table_row = torch.tensor(page_ids, dtype=torch.long, device=dev)
            self._scatter_window(cp.row_cache, table_row, start,
                                 start + width)
            if cp.seen_row is not None:
                # Prompt tokens enter the presence mask before the sample.
                cp.seen_row[0, tokens[0]] = True
            if is_final:
                first = sample_token(logits[:, -1, :], self.sampling,
                                     cp.generator, cp.seen_row)
                if cp.seen_row is not None:
                    cp.seen_row[0, first] = True
                first_int = int(first[0])
        cp.cursor = start + n_real
        cp.n_chunks += 1
        if self.prefix is not None:
            n_full = cp.cursor // page
            adopted = self.prefix.insert(
                cp.prompt[: cp.cursor], cp.page_ids[:n_full]
            )
            self.allocator.hold(adopted)
        if not is_final:
            return "ran"
        cp.first = first
        cp.first_int = first_int
        cp.done0 = self.eos_id is not None and cp.first_int == self.eos_id
        return "done"

    def finalize_chunked(
        self, slot: int, cp: ChunkedPrefill, budget: int
    ) -> None:
        """Occupy ``slot`` with a completed chunked prefill: the arena
        already holds the prompt's K/V, so ``insert_paged`` only installs
        the table row, the cursors and the slot state."""
        self.insert_paged(
            slot, cp.row_cache, cp.first_int, len(cp.prompt), budget,
            cp.page_ids, len(cp.page_ids), row_seen=cp.seen_row,
        )

    def abandon_chunked(self, cp: ChunkedPrefill) -> int:
        """Preemption or failure: drop the row's page references. The
        trie-checkpointed full pages stay held (the resume point of a
        re-admission's ``start_chunked``); the rest free at once. Returns
        the pages freed."""
        freed = self.allocator.release(cp.page_ids)
        cp.page_ids = []
        return freed

    @torch.no_grad()
    def release_slot(self, slot: int) -> int:
        """Free ``slot``: freeze its masks, zero its page-table row,
        return its pages to the allocator. Returns the pages actually
        freed (shared or trie-held pages may stay resident)."""
        self.done[slot] = True
        self.remaining[slot] = 0
        self.cache[0].table[slot] = 0
        freed = self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        return freed

    def retire(self, slot: int) -> None:
        """Error-path retire, page-aware (frees the row's pages)."""
        self.release_slot(slot)

    def insert(self, *a, **k):
        raise TypeError(
            "PagedSlotPool: use insert_paged (pages must be acquired "
            "through the allocator first)"
        )
