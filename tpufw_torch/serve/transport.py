"""Replica-to-replica transport: length-prefixed frames over an
in-process loopback (CI gangs both roles in one process) or a TCP
socket (cross-pod, discovered via tpufw_torch.cluster.discovery). A
copy of ``tpufw.serve.transport``.

One frame = u32 big-endian length + payload bytes. Payloads are
opaque — page bundles and JSON control messages share the framing.
Stdlib only.
"""

from __future__ import annotations

import queue
import socket
import struct
import time
from typing import Optional, Tuple

#: Frames above this are refused on read — a corrupt length prefix
#: must not allocate unbounded memory (1 GiB covers any real arena's
#: worth of pages with room to spare).
MAX_FRAME = 1 << 30


class TransportError(ConnectionError):
    """Framing violation or closed peer."""


def pack_frame(payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise TransportError(f"frame too large ({len(payload)} bytes)")
    return struct.pack(">I", len(payload)) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise TransportError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(got)
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(pack_frame(payload))


def recv_frame(sock: socket.socket) -> bytes:
    (length,) = struct.unpack(">I", _read_exact(sock, 4))
    if length > MAX_FRAME:
        raise TransportError(f"frame length {length} exceeds cap")
    return _read_exact(sock, length)


class LoopbackTransport:
    """In-process bidirectional frame pipe: ``a`` and ``b`` are the
    two ends, each with send/recv. CI runs a prefill and a decode
    replica in one process over this — same framing code path as TCP,
    no sockets."""

    class _End:
        def __init__(self, out_q: "queue.Queue", in_q: "queue.Queue"):
            self._out = out_q
            self._in = in_q

        def send(self, payload: bytes) -> None:
            # Round-trip through the framing so loopback exercises the
            # same encode/decode path a socket would.
            frame = pack_frame(payload)
            self._out.put(frame)

        def recv(self, timeout: Optional[float] = None) -> bytes:
            try:
                frame = self._in.get(timeout=timeout)
            except queue.Empty:
                raise TransportError("loopback recv timeout") from None
            (length,) = struct.unpack(">I", frame[:4])
            if length != len(frame) - 4:
                raise TransportError("loopback frame length mismatch")
            return frame[4:]

    def __init__(self):
        q_ab: "queue.Queue" = queue.Queue()
        q_ba: "queue.Queue" = queue.Queue()
        self.a = self._End(q_ab, q_ba)
        self.b = self._End(q_ba, q_ab)


class TcpTransport:
    """Client end of a framed TCP connection to a replica."""

    def __init__(self, host: str, port: int, timeout: float = 600.0):
        self.addr = (host, int(port))
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._sock.settimeout(timeout)

    def send(self, payload: bytes) -> None:
        send_frame(self._sock, payload)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        if timeout is not None:
            self._sock.settimeout(timeout)
        return recv_frame(self._sock)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def rpc(
    host: str, port: int, payload: bytes, timeout: float = 600.0
) -> Tuple[bytes, float]:
    """One framed request/response round trip on a fresh connection;
    returns ``(reply, rtt_s)``. The measured wall (connect + send +
    remote work + recv) is what request tracing calls the prefill /
    decode rpc stage — the remote subtracts its own engine wall from
    it to expose pure wire time."""
    t0 = time.perf_counter()
    with TcpTransport(host, port, timeout=timeout) as t:
        t.send(payload)
        reply = t.recv()
    return reply, time.perf_counter() - t0


def serve_frames(port: int = 0, host: str = "0.0.0.0"):
    """Minimal framed TCP listener. Returns (socket, bound_port); the
    caller runs :func:`accept_loop` on its own thread with the
    per-frame handler. Kept tiny and synchronous — replica RPCs are
    one-in-one-out."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, int(port)))
    srv.listen(16)
    return srv, srv.getsockname()[1]


def accept_loop(srv: socket.socket, handler) -> None:
    """Serve until the listening socket is shut down
    (``srv.shutdown(socket.SHUT_RDWR)``: on Linux a close alone does not
    wake a thread blocked in accept). One thread per connection keeps a
    slow decode from blocking the next prefill."""
    import threading

    def _conn(conn: socket.socket) -> None:
        with conn:
            conn.settimeout(600.0)
            while True:
                try:
                    frame = recv_frame(conn)
                except (TransportError, OSError):
                    return
                try:
                    reply = handler(frame)
                except Exception as e:  # noqa: BLE001 — report to peer
                    import json

                    reply = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode()
                try:
                    send_frame(conn, reply)
                except (TransportError, OSError):
                    return

    while True:
        try:
            conn, _ = srv.accept()
        except OSError:
            return  # listener closed: shutdown
        threading.Thread(target=_conn, args=(conn,), daemon=True).start()
