"""Host-side radix/trie prefix cache over KV pages (port of
``tpufw.infer.prefix``, by copy: pure Python).

This trie maps PAGE-GRANULAR token chunks (the paged pool's fixed page
size, ``tpufw_torch.infer.pages``) to resident physical pages: a new
request walks its prompt down the trie, and every matched full page is
attached to the row's page table by reference, so prefill skips the
shared tokens and device memory holds one copy.

Copy-on-write is structural, not a device copy: only FULL pages strictly
before a row's first write slot are ever shared (the pool enforces
``shared_len <= prompt_len - 1``, and decode writes start at
``prompt_len``), so divergence after the shared point lands in the row's
private pages by construction.

Sharing and lifetime are split across two owners:
- rows reference pages via ``PageAllocator`` refcounts (released at
  retire);
- the trie HOLDS resident pages (``allocator.hold``) so they survive
  their origin row, until ``evict`` drops refcount-0 leaves LRU-first
  under memory pressure.

The spill tier (``tpufw_torch.infer.spill``) rides on ``evict``'s
``on_evict`` hook, which sees each victim's full token path before its
page is dropped; ``version`` and ``paths`` serve the prefix digests of
``tpufw_torch.serve.bundle.advertised_digests``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("children", "page", "stamp", "parent", "key")

    def __init__(self, parent: Optional["_Node"], key, page: int):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.key = key
        self.page = page
        self.stamp = 0


class PrefixCache:
    """Radix trie keyed by page-sized token chunks.

    Each node is one FULL page of tokens and carries the physical page
    id holding that chunk's K/V (valid only under its ancestors: K/V at
    slot j depends on all tokens <= j, so a path from the root is the
    unit of reuse, never a node alone).
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _Node(None, None, -1)
        self._tick = 0
        self._n_nodes = 0
        #: Content version: bumps on insert and evict, NOT on match, so
        #: a digest walk can be cached until the resident set changes.
        self.version = 0

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        p = self.page_size
        n_full = len(tokens) // p
        return [tuple(tokens[i * p:(i + 1) * p]) for i in range(n_full)]

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Physical page ids of the longest resident full-page prefix
        of ``tokens`` (possibly empty). Touches the path's LRU stamps;
        the CALLER takes row references (``allocator.ref``) on the ids
        it actually uses."""
        ids: List[int] = []
        node = self.root
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            self._tick += 1
            child.stamp = self._tick
            ids.append(child.page)
            node = child
        return ids

    def insert(
        self, tokens: Sequence[int], page_ids: Sequence[int]
    ) -> List[int]:
        """Register ``tokens``' full-page chunks as resident in
        ``page_ids`` (one id per full page, the row's own pages).
        Chunks already on the trie keep their EXISTING page (same
        tokens => same K/V content; the duplicate page stays row-owned
        and dies with the row). Returns the ids newly adopted by the
        trie; the caller must ``allocator.hold`` exactly those."""
        node = self.root
        adopted: List[int] = []
        for chunk, pid in zip(self._chunks(tokens), page_ids):
            child = node.children.get(chunk)
            if child is None:
                child = _Node(node, chunk, int(pid))
                node.children[chunk] = child
                self._n_nodes += 1
                self.version += 1
                adopted.append(int(pid))
            self._tick += 1
            child.stamp = self._tick
            node = child
        return adopted

    @staticmethod
    def _path_tokens(node: _Node) -> Tuple[int, ...]:
        """Full token path from the root to ``node`` (a page's K/V is only
        valid under its ancestors, so the path IS a spill entry's
        identity)."""
        chunks: List[Tuple[int, ...]] = []
        while node.parent is not None:
            chunks.append(node.key)
            node = node.parent
        out: List[int] = []
        for chunk in reversed(chunks):
            out.extend(chunk)
        return tuple(out)

    def evict(
        self,
        n: int,
        allocator,
        on_evict: "Optional[Callable[[Tuple[int, ...], int], None]]" = None,
    ) -> List[int]:
        """Drop up to ``n`` refcount-0 LEAF pages, least-recently-used
        first, cascading into parents as they become leaves. Returns
        the dropped page ids (``allocator.drop`` already ran: ids are
        free iff no row still references them).

        ``on_evict(path_tokens, page_id)`` fires BEFORE the drop, while
        the page's arena bytes are still valid: the spill tier's hook,
        which copies the page to host memory so the eviction frees
        device memory without forgetting the K/V."""
        dropped: List[int] = []
        while len(dropped) < n:
            victim = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                if node is not self.root and not node.children:
                    if allocator.refs.get(node.page, 0) == 0 and (
                        victim is None or node.stamp < victim.stamp
                    ):
                        victim = node
                else:
                    stack.extend(node.children.values())
            if victim is None:
                break
            if on_evict is not None:
                on_evict(self._path_tokens(victim), victim.page)
            del victim.parent.children[victim.key]
            self._n_nodes -= 1
            self.version += 1
            allocator.drop([victim.page])
            dropped.append(victim.page)
        return dropped

    def paths(
        self, max_depth: int, limit: int = 0
    ) -> List[Tuple[int, ...]]:
        """Token paths of every resident node up to ``max_depth`` chunks
        deep (optionally capped at ``limit`` paths): the digest walk.
        Read-only: no LRU touch, no version bump."""
        out: List[Tuple[int, ...]] = []
        stack: List[Tuple[_Node, Tuple[int, ...], int]] = [
            (self.root, (), 0)
        ]
        while stack:
            node, toks, depth = stack.pop()
            if depth >= max_depth:
                continue
            for chunk, child in node.children.items():
                path = toks + chunk
                out.append(path)
                if limit and len(out) >= limit:
                    return out
                stack.append((child, path, depth + 1))
        return out

    def __len__(self) -> int:
        return self._n_nodes
