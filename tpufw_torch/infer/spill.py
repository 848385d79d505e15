"""Host-RAM page-spill tier: the cold store behind the paged KV arena
(a copy of ``tpufw.infer.spill``: standard library only).

Device memory holds the hot working set (the page arena); everything
colder lives here. Two kinds of entries share one LRU:

- ``"trie"``: one evicted prefix-cache page (key: the full-page token
  path that produced it). Restoring one skips that chunk's prefill and
  its arena residency until it is referenced again.
- ``"session"``: one drained slot's complete page bundle (key: the
  sticky session id), for the disaggregated roles that resume a live
  generation on another replica.

Values are opaque bytes. By convention they are TPFB page bundles
(``tpufw_torch.serve.bundle``, byte-compatible with ``tpufw``'s): int8
codes and page-structured scales ship raw, and the restore path scatters
them back as stored, so spill -> restore is bit-equal by construction.
This module never parses them; the bundle codec and the device <-> numpy
hop stay with the pool (``tpufw_torch.infer.pages``) and
``tpufw_torch.serve.bundle.attach_spill``.

Capacity is counted in PAGES (the arena's own unit). When the RAM budget
overflows, LRU entries demote to the optional directory tier
(``TPUFW_KV_SPILL_DIR``); with no directory they are dropped oldest
first. The directory tier is also the cross-process session store
(``tpufw_torch.serve.bundle.session_path`` computes the same names).

File layout: ``<dir>/<kind>-<blake2b16(key)>.tpfb``, written via temp
file + ``os.replace`` so a reader never sees a torn bundle.

Thread-safe: one lock around the index; file writes happen under it too
(spill sits off the decode hot path: eviction and drain are the only
writers).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

#: Spill keys are (kind, name): kind selects the namespace, name is
#: the trie token-path repr or the session id.
Key = Tuple[str, str]


def key_name(kind: str, name: str) -> str:
    """Stable on-disk basename for a spill entry — blake2b keeps
    arbitrary session ids / token paths filesystem-safe and
    collision-resistant."""
    h = hashlib.blake2b(name.encode("utf-8"), digest_size=16)
    return f"{kind}-{h.hexdigest()}.tpfb"


def trie_key(tokens: Iterable[int]) -> str:
    """Canonical spill name for a trie page: the full token path from
    the root (a path, never a lone chunk — KV at slot j depends on
    every token <= j, same invariant as the trie itself)."""
    return ",".join(str(int(t)) for t in tokens)


class _Entry:
    __slots__ = ("data", "pages", "on_disk")

    def __init__(self, data: Optional[bytes], pages: int, on_disk: bool):
        self.data = data  # None once demoted to the directory tier
        self.pages = pages
        self.on_disk = on_disk


class SpillTier:
    """LRU byte store with a RAM budget (in pages) and an optional
    directory overflow/persistence tier.

    ``put`` admits at the MRU end and evicts LRU entries past the
    budget (demote-to-disk when a directory is set, drop otherwise).
    ``get`` touches LRU order and transparently reloads demoted
    entries from disk. ``pop`` removes an entry everywhere — the
    restore paths use it so a consumed spill entry frees its host RAM
    the moment its pages are back in the arena.
    """

    def __init__(
        self,
        max_ram_pages: int,
        directory: str = "",
        *,
        persist_kinds: Tuple[str, ...] = ("session",),
    ):
        self.max_ram_pages = int(max_ram_pages)
        self.directory = str(directory or "")
        #: Kinds written through to the directory at put time (not
        #: just on demotion): sessions must survive the PROCESS — the
        #: router re-homes them from another replica's filesystem
        #: view — so they hit disk while the drain handler still runs.
        self.persist_kinds = tuple(persist_kinds)
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        # Entry ledger. The tier stores BYTES, not arena pages: an
        # entry here holds nothing the page allocator tracks.
        self._entries: "OrderedDict[Key, _Entry]" = OrderedDict()
        # Counters for the tpufw_kv_* series (read by the server's
        # /metrics). Monotonic ones never reset.
        self.spilled_bytes_total = 0
        self.spilled_pages_total = 0
        self.restored_total = 0
        self.dropped_total = 0

    # ------------------------------------------------------ helpers

    def _path(self, key: Key) -> str:
        return os.path.join(self.directory, key_name(key[0], key[1]))

    def _write_file(self, key: Key, data: bytes) -> bool:
        if not self.directory:
            return False
        path = self._path(key)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # readers never see a torn bundle
            return True
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def _ram_pages_locked(self) -> int:
        return sum(
            e.pages for e in self._entries.values() if e.data is not None
        )

    def _shrink_locked(self) -> None:
        """Demote/drop LRU entries until RAM is back under budget."""
        while self._ram_pages_locked() > self.max_ram_pages:
            victim_key = None
            for k, e in self._entries.items():  # LRU first
                if e.data is not None:
                    victim_key = k
                    break
            if victim_key is None:
                break
            e = self._entries[victim_key]
            if e.on_disk or self._write_file(victim_key, e.data):
                e.on_disk = True
                e.data = None  # demoted: pages accounted on disk now
            else:
                # No directory to demote into: the LRU entry drops.
                del self._entries[victim_key]
                self.dropped_total += 1

    # ------------------------------------------------------ public

    def put(self, kind: str, name: str, data: bytes, pages: int) -> None:
        """Admit ``data`` (a TPFB bundle covering ``pages`` arena
        pages) at the MRU end, evicting past the RAM budget."""
        key = (kind, name)
        with self._lock:
            old = self._entries.pop(key, None)
            on_disk = bool(old and old.on_disk)
            if kind in self.persist_kinds:
                on_disk = self._write_file(key, data) or on_disk
            self._entries[key] = _Entry(data, int(pages), on_disk)
            self.spilled_bytes_total += len(data)
            self.spilled_pages_total += int(pages)
            self._shrink_locked()

    def get(self, kind: str, name: str) -> Optional[bytes]:
        """Fetch bytes (touching LRU order), reloading a demoted entry
        from the directory tier; None on miss or torn file."""
        key = (kind, name)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            if e.data is not None:
                return e.data
            try:
                with open(self._path(key), "rb") as f:
                    return f.read()
            except OSError:
                # Torn/unreadable file: drop, never serve partial KV.
                del self._entries[key]
                self.dropped_total += 1
                return None

    def pop(self, kind: str, name: str) -> None:
        """Remove an entry from RAM and disk (consumed by a restore,
        or invalidated). Missing entries are a no-op."""
        key = (kind, name)
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self.restored_total += 1
                if e.on_disk:
                    try:
                        os.unlink(self._path(key))
                    except OSError:
                        pass

    def __contains__(self, key: Key) -> bool:
        with self._lock:
            return key in self._entries

    def names(self, kind: str) -> List[str]:
        """Current entry names of one kind, LRU -> MRU (the engine
        advertises trie names so the router's affinity hash can steer
        to restorable — not just resident — prefixes)."""
        with self._lock:
            return [k[1] for k in self._entries if k[0] == kind]

    def stats(self) -> Dict[str, int]:
        """Occupancy + lifetime counters for signals()/metrics: pages
        and bytes split by tier, plus monotonic spill/restore/drop
        totals."""
        with self._lock:
            ram_pages = ram_bytes = disk_pages = 0
            for e in self._entries.values():
                if e.data is not None:
                    ram_pages += e.pages
                    ram_bytes += len(e.data)
                elif e.on_disk:
                    disk_pages += e.pages
            return {
                "entries": len(self._entries),
                "ram_pages": ram_pages,
                "ram_bytes": ram_bytes,
                "dir_pages": disk_pages,
                "spilled_bytes_total": self.spilled_bytes_total,
                "spilled_pages_total": self.spilled_pages_total,
                "restored_total": self.restored_total,
                "dropped_total": self.dropped_total,
            }
