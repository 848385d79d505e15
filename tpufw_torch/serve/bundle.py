"""Page-bundle wire format (a copy of ``tpufw.serve.bundle``, byte for
byte on the wire): the serialized form of KV pages plus cursors, as
``PagedSlotPool.export_pages_state`` produces them for the spill tier.

Layout (all integers big-endian):

    MAGIC(4) VERSION(u16) HEADER_LEN(u32) HEADER(json, utf-8)
    BODY (concatenated C-order array bytes, header-manifest order)
    CRC32(u4)  — zlib.crc32 over MAGIC..BODY

The header carries everything needed to reject a bundle cleanly BEFORE
touching an arena: format version, page geometry, kv_quant, and a
per-array manifest (path, shape, dtype). int8 arenas ship their int8
codes + fp32 page-structured scales raw, so a restore is bit-identical
storage and the wire stays ~4x cheaper than bf16.

bfloat16 has no numpy name. ``tpufw`` resolves it through ml_dtypes (a
jax dependency); this copy needs no such package: a bf16 array travels
as its raw 16-bit patterns, a ``numpy.uint16`` array beside the wire
name ``"bfloat16"`` in the state's ``dtypes`` list, and decodes the same
way (``tpufw_torch.infer.pages`` views the patterns as
``torch.bfloat16``). The bytes on the wire are the same as ``tpufw``'s,
so bundles cross between the two packages in both directions.

Standard library + numpy only.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
import zlib
from typing import Any, Dict, List, Sequence

import numpy as np

MAGIC = b"TPFB"
VERSION = 1

#: The single source of truth for the bundle header: key -> (python
#: type, since-version, required). encode_bundle builds the header
#: from this table, decode_bundle validates presence + type against
#: it (required keys are rejected uniformly when missing), and
#: peek_trace takes its type check from the same row. Unknown header
#: keys are ignored on decode (forward compatibility: a newer
#: producer may add optional keys without a version bump); a key only
#: becomes load-bearing by gaining a row here.
HEADER_SCHEMA: Dict[str, tuple] = {
    "version": (int, 1, True),
    "arrays": (list, 1, True),
    "page": (int, 1, True),
    "kv_quant": (str, 1, True),
    "n_pages": (int, 1, True),
    "token": (int, 1, True),
    "pos": (int, 1, True),
    "remaining": (int, 1, True),
    "done": (bool, 1, True),
    "cache_index": (int, 1, True),
    "trace": (dict, 1, False),
    # Prompt token ids, optional: a decode replica running
    # speculative self-drafting (TPUFW_SERVE_SPEC_K) needs the
    # request's history to mine n-gram proposals from; bundles from
    # producers that predate the field still splice fine — the slot
    # just drafts from its generated tokens alone.
    "prompt": (list, 1, False),
    # KV-fabric session resumption fields, optional (VERSION stays 1;
    # old decoders splice these bundles unchanged and simply start the
    # emitted-token list from `token` alone):
    # - "session": the router's sticky session id, stamped at prefill
    #   and carried through drain bundles so the router can re-home a
    #   killed replica's sessions by name.
    # - "tokens": every token the ORIGIN replica already emitted (the
    #   last one == `token`). A resuming replica seeds its emitted
    #   list from this so the client receives the full, divergence-
    #   free sequence across the migration seam.
    "session": (str, 1, False),
    "tokens": (list, 1, False),
}

#: Non-array metadata fields copied between state dict and header
#: verbatim — derived from the schema, not a second hand-maintained
#: list ("trace" is optional and handled separately).
_META_FIELDS = tuple(
    k for k in HEADER_SCHEMA if k not in ("version", "arrays", "trace")
)


class BundleError(ValueError):
    """A malformed/mismatched bundle, rejected before any arena
    write."""


#: Wire dtype names whose arrays travel as raw bit patterns of this
#: numpy dtype (numpy has no bfloat16).
_BITS = {"bfloat16": np.dtype(np.uint16)}


def _np_dtype(name: str) -> np.dtype:
    if name in _BITS:
        return _BITS[name]
    try:
        return np.dtype(name)
    except TypeError:
        raise BundleError(f"unknown array dtype {name!r}") from None


def encode_bundle(state: Dict[str, Any]) -> bytes:
    """Serialize an ``export_slot`` state dict. The optional ``seen``
    row (repetition-penalty mask) travels as one more manifest entry
    under the reserved path ``"seen"``. An optional ``trace`` dict
    (request-trace meta + per-stage timings)
    rides in the header; decoders that predate it ignore unknown
    header keys, so VERSION stays 1."""
    arrays = [np.ascontiguousarray(a) for a in state["arrays"]]
    paths = [str(p) for p in state["paths"]]
    # Wire dtype names: an array of raw bf16 bit patterns names itself in
    # ``dtypes``; every other array by its numpy name.
    dtypes = list(state.get("dtypes") or [a.dtype.name for a in arrays])
    if state.get("seen") is not None:
        arrays.append(np.ascontiguousarray(state["seen"]))
        paths.append("seen")
        dtypes.append(arrays[-1].dtype.name)
    manifest = [
        {
            "path": p,
            "shape": list(a.shape),
            "dtype": d,
        }
        for p, a, d in zip(paths, arrays, dtypes)
    ]
    header = {"version": VERSION, "arrays": manifest}
    for key, (typ, _since, required) in HEADER_SCHEMA.items():
        if key in header:
            continue  # built above
        if required:
            header[key] = state[key]
        elif isinstance(state.get(key), typ):
            header[key] = state[key]
    hjson = json.dumps(header, sort_keys=True).encode("utf-8")
    parts = [MAGIC, struct.pack(">HI", VERSION, len(hjson)), hjson]
    parts.extend(a.tobytes() for a in arrays)
    payload = b"".join(parts)
    return payload + struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF)


def decode_bundle(data: bytes) -> Dict[str, Any]:
    """Parse bundle bytes back into an ``export_slot``-shaped state
    dict; raises BundleError on any magic/version/manifest/checksum
    mismatch — a tampered or truncated bundle must never reach the
    arena. Header fields are validated (presence AND type) against
    HEADER_SCHEMA, the same table encode_bundle writes from."""
    if len(data) < 14:
        raise BundleError(f"bundle truncated ({len(data)} bytes)")
    if data[:4] != MAGIC:
        raise BundleError(f"bad magic {data[:4]!r} (want {MAGIC!r})")
    body, (crc,) = data[:-4], struct.unpack(">I", data[-4:])
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise BundleError("checksum mismatch — bundle corrupt in flight")
    version, hlen = struct.unpack(">HI", data[4:10])
    if version != VERSION:
        raise BundleError(
            f"bundle version {version} != supported {VERSION}"
        )
    if 10 + hlen > len(body):
        raise BundleError("header overruns bundle body")
    try:
        header = json.loads(body[10:10 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BundleError(f"unparseable header: {e}") from None
    offset = 10 + hlen
    arrays = []
    for entry in header.get("arrays", []):
        dtype = _np_dtype(str(entry["dtype"]))
        shape = tuple(int(d) for d in entry["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if offset + nbytes > len(body):
            raise BundleError(
                f"array {entry.get('path')!r} overruns bundle body"
            )
        arrays.append(
            np.frombuffer(
                body, dtype=dtype, count=int(np.prod(shape, dtype=np.int64)),
                offset=offset,
            ).reshape(shape)
        )
        offset += nbytes
    if offset != len(body):
        raise BundleError(
            f"{len(body) - offset} trailing bytes after last array"
        )
    paths = [str(e["path"]) for e in header.get("arrays", [])]
    seen = None
    if paths and paths[-1] == "seen":
        seen = arrays.pop()
        paths.pop()
    for key, (typ, _since, required) in HEADER_SCHEMA.items():
        if key not in header:
            if required:
                raise BundleError(
                    f"header missing required field {key!r}"
                )
            continue
        value = header[key]
        # bool is an int subclass; "done" must be the only bool field.
        if typ is int and isinstance(value, bool):
            raise BundleError(
                f"header field {key!r} must be an integer, got bool"
            )
        if not isinstance(value, typ):
            raise BundleError(
                f"header field {key!r} must be {typ.__name__}, got "
                f"{type(value).__name__}"
            )
    if header["version"] != version:
        raise BundleError(
            f"header version {header['version']} disagrees with frame "
            f"prefix {version} — producer drift"
        )
    state: Dict[str, Any] = {}
    for k in _META_FIELDS:
        # Optional fields (schema required=False) decode to None when
        # the producer predates them; required ones were proven
        # present by the schema pass above.
        state[k] = header.get(k)
    state["paths"] = paths
    state["arrays"] = arrays
    state["dtypes"] = [
        str(e["dtype"]) for e in header.get("arrays", [])
    ][: len(arrays)]
    state["seen"] = seen
    # Absent on bundles from pre-trace producers — still a valid
    # bundle, the request just has no cross-role correlation. When
    # present the schema pass above already proved it a dict.
    state["trace"] = header.get("trace")
    return state


def peek_trace(data: bytes) -> "Dict[str, Any] | None":
    """Header-only read of the trace meta — no array parsing, no CRC
    walk over the (multi-MB) body, never raises. The router uses this
    to pull engine-reported stage timings out of a bundle it otherwise
    treats as opaque bytes, including bundles that would fail full
    decode (so a request that dies in flight still gets attributed)."""
    try:
        if data[:4] != MAGIC:
            return None
        _version, hlen = struct.unpack(">HI", data[4:10])
        header = json.loads(data[10:10 + hlen].decode("utf-8"))
        trace = header.get("trace")
        # Same type row decode_bundle enforces — one schema, two
        # consumers.
        if isinstance(trace, HEADER_SCHEMA["trace"][0]):
            return trace
        return None
    except Exception:
        return None


# --------------------------------------------------- prefix digests
#
# The affinity identity both sides of the wire agree on: a cumulative
# blake2b chain over page-aligned token chunks — EXACTLY the radix
# trie's chunking (tpufw_torch.infer.prefix splits at full pages and drops
# the tail), so digest i names the same KV a trie path of depth i+1
# holds. Replicas advertise the digests of their resident (and
# spilled-but-restorable) trie paths in signals(); the router hashes
# an incoming prompt the same way and steers to the deepest match.
# Cumulative chaining means a digest commits to the WHOLE path, never
# a lone chunk — matching the trie's path-is-the-unit-of-reuse rule.

#: Digest width: 8 bytes / 16 hex chars. Affinity is a routing hint
#: backed by an exact token-compare in the trie, so collisions cost a
#: misrouted request, never a wrong token.
PREFIX_DIGEST_SIZE = 8


def chunk_digests(
    tokens: Sequence[int], page: int, k: int
) -> List[str]:
    """Cumulative digests of the first ``min(k, full-pages)`` page-
    aligned chunks of ``tokens``; digest i covers chunks 0..i. Pure
    stdlib: the router calls this per request."""
    out: List[str] = []
    if page <= 0 or k <= 0:
        return out
    h = hashlib.blake2b(digest_size=PREFIX_DIGEST_SIZE)
    n_full = len(tokens) // page
    for i in range(min(int(k), n_full)):
        chunk = tokens[i * page:(i + 1) * page]
        h.update(",".join(str(int(t)) for t in chunk).encode())
        h.update(b"|")  # chunk boundary: len(chunk) is fixed, but be explicit
        out.append(h.hexdigest())
    return out


# ----------------------------------------------------- session store
#
# The cross-process half of the spill tier (tpufw_torch.infer.spill): a
# drained replica writes each live session's bundle to a shared
# directory (TPUFW_KV_SPILL_DIR), and the ROUTER — which never loads
# the model, hence these helpers living here — reads it back to re-home the
# session onto a surviving replica. File names match SpillTier's
# directory tier (kind "session"), so an engine-side spill and a
# drain write land on the same path.


def session_path(directory: str, session: str) -> str:
    """On-disk path for one session's spill bundle — blake2b of the
    id keeps arbitrary session strings filesystem-safe."""
    h = hashlib.blake2b(session.encode("utf-8"), digest_size=16)
    return os.path.join(directory, f"session-{h.hexdigest()}.tpfb")


def store_session(directory: str, session: str, data: bytes) -> str:
    """Atomically persist a session bundle (temp file + rename: a
    concurrently re-homing router never sees a torn bundle)."""
    os.makedirs(directory, exist_ok=True)
    path = session_path(directory, session)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def load_session(directory: str, session: str) -> "bytes | None":
    """Fetch a session bundle, or None when the session was never
    drained (the caller falls back to a plain 502)."""
    try:
        with open(session_path(directory, session), "rb") as f:
            return f.read()
    except OSError:
        return None


def drop_session(directory: str, session: str) -> None:
    """Delete a consumed session bundle — a re-homed session must not
    resurrect from a stale spill file on its next failover."""
    try:
        os.unlink(session_path(directory, session))
    except OSError:
        pass


# ------------------------------------------------------ spill wiring

def attach_spill(pool, tier, *, on_restore=None):
    """Wire ``tier`` (``tpufw_torch.infer.spill.SpillTier``) into
    ``pool``'s trie-spill callbacks with this module's TPFB codec at the
    boundary: an evicted trie page is encoded exactly like a migration
    bundle (raw int8 codes + page-structured scales), and restore
    decodes into the state ``import_pages`` scatters back, so
    spill -> restore is bit-equal by construction.

    ``on_restore(seconds)`` feeds the ``tpufw_kv_restore_seconds``
    histogram where a metrics registry exists (host-side fetch + decode
    wall; the device scatter rides the admission). ``tpufw``'s ``events``
    hook is not ported: the event log is ROADMAP.md Queue 1 item 13."""
    from tpufw_torch.infer.spill import trie_key

    def _spill(path_tokens, state):
        data = encode_bundle(state)
        tier.put(
            "trie", trie_key(path_tokens), data, int(state["n_pages"])
        )

    def _restore(path_tokens):
        name = trie_key(path_tokens)
        t0 = time.perf_counter()
        data = tier.get("trie", name)
        if data is None:
            return None
        try:
            state = decode_bundle(data)
        except BundleError:
            tier.pop("trie", name)  # torn entry: never retry it
            return None
        # Consume the entry: its pages are back in the arena, and a
        # kept host copy would go stale the moment decode appends.
        tier.pop("trie", name)
        if on_restore is not None:
            on_restore(time.perf_counter() - t0)
        return state

    pool.trie_spill = _spill
    pool.trie_restore = _restore


def advertised_digests(pool, tier, k: int, cache: Dict[str, Any]):
    """The digest set a replica advertises in its ``signals()`` reply:
    one cumulative digest per resident trie path (every node IS a
    path, so every depth <= k is covered by enumeration) plus every
    cumulative depth of each spilled-but-restorable path. Cached in
    ``cache`` keyed on (trie version, spill counters, k) — recomputed
    only at chunk boundaries that actually changed the resident set,
    which is the "digest updates at chunk boundaries" contract."""
    prefix = getattr(pool, "prefix", None)
    ver = prefix.version if prefix is not None else -1
    stamp = None
    if tier is not None:
        stamp = (
            tier.spilled_pages_total,
            tier.restored_total,
            tier.dropped_total,
        )
    key = (ver, stamp, int(k))
    if cache.get("key") == key:
        return cache["digests"]
    page = int(pool.page)
    out: List[str] = []
    seen = set()
    if prefix is not None:
        for path in prefix.paths(int(k), limit=512):
            d = chunk_digests(path, page, k)
            if d and d[-1] not in seen:
                seen.add(d[-1])
                out.append(d[-1])
    if tier is not None:
        for name in tier.names("trie"):
            toks = [int(t) for t in name.split(",") if t]
            for h in chunk_digests(toks, page, k):
                if h not in seen:
                    seen.add(h)
                    out.append(h)
    out = out[:1024]
    cache["key"] = key
    cache["digests"] = out
    return out
