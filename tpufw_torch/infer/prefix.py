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

Not ported with it: the spill tier's eviction hook and path walk
(``on_evict``, ``paths``, ``version``; ROADMAP.md Queue 1 items 8 and 9).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


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
                adopted.append(int(pid))
            self._tick += 1
            child.stamp = self._tick
            node = child
        return adopted

    def evict(self, n: int, allocator) -> List[int]:
        """Drop up to ``n`` refcount-0 LEAF pages, least-recently-used
        first, cascading into parents as they become leaves. Returns
        the dropped page ids (``allocator.drop`` already ran: ids are
        free iff no row still references them)."""
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
            del victim.parent.children[victim.key]
            self._n_nodes -= 1
            allocator.drop([victim.page])
            dropped.append(victim.page)
        return dropped

    def __len__(self) -> int:
        return self._n_nodes
