"""Length-prefixed socket messages for the cluster tier
(``apex_tpu/serving/cluster/protocol.py``, stdlib only; copied, not
imported).

One frame format carries both the small JSON control messages (submit,
poll, stats) and the multi-megabyte KV handoffs:

::

    [4 bytes big-endian]  header length H
    [H bytes]             JSON header (utf-8 object)
    [b0 bytes] [b1 bytes] ...   raw binary blobs, lengths from
                                header["_blobs"] = [b0, b1, ...]

Tensors ride as raw blobs, so a KV handoff never pays a base64/JSON
round trip.  Everything is stdlib ``socket`` + ``struct`` + ``json``:
this module imports neither torch nor numpy, and its frames are byte for
byte the JAX package's, so either package's workers and routers talk to
the other's.

Framing rules:

- a peer closing cleanly BETWEEN frames reads as ``None`` from
  :func:`recv_msg` (orderly shutdown, not an error);
- a connection dying MID-frame raises :class:`ProtocolError` — a
  half-received KV handoff must never be silently truncated into a
  "valid" smaller one;
- both length fields are bounded (:data:`MAX_HEADER`,
  :data:`MAX_MESSAGE`) so a corrupt or hostile peer cannot make the
  receiver allocate unbounded memory.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import List, Optional, Sequence, Tuple

__all__ = ["ProtocolError", "send_msg", "recv_msg", "MAX_HEADER",
           "MAX_MESSAGE"]

MAX_HEADER = 16 * 1024 * 1024          # control plane stays small
MAX_MESSAGE = 2 * 1024 * 1024 * 1024   # KV handoffs are big, not infinite

_LEN = struct.Struct("!I")


class ProtocolError(RuntimeError):
    """Malformed frame or a connection lost mid-frame."""


def _recv_exact(sock: socket.socket, n: int,
                *, at_boundary: bool = False) -> Optional[bytes]:
    """Read exactly ``n`` bytes.  EOF at a frame boundary (nothing read
    yet and ``at_boundary``) returns None; EOF anywhere else raises —
    a partial frame is corruption, not shutdown."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ProtocolError(f"connection lost mid-frame: {e}") from e
        if not chunk:
            if at_boundary and got == 0:
                return None
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, header: dict,
             blobs: Sequence[bytes] = ()) -> int:
    """Send one frame; returns the bytes written (the wire cost a
    caller records as ``cluster.handoff_bytes``).  ``header`` must be a
    JSON-serializable dict; ``_blobs`` is reserved (stamped here)."""
    if not isinstance(header, dict):
        raise ProtocolError(f"header must be a dict, got "
                            f"{type(header).__name__}")
    head = dict(header)
    blobs = [bytes(b) if isinstance(b, (bytearray, memoryview)) else b
             for b in blobs]
    head["_blobs"] = [len(b) for b in blobs]
    payload = json.dumps(head, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_HEADER:
        raise ProtocolError(f"header {len(payload)} bytes exceeds "
                            f"MAX_HEADER {MAX_HEADER}")
    total = _LEN.size + len(payload) + sum(len(b) for b in blobs)
    if total > MAX_MESSAGE:
        raise ProtocolError(f"message {total} bytes exceeds MAX_MESSAGE "
                            f"{MAX_MESSAGE}")
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)
    for b in blobs:
        sock.sendall(b)
    return total


def recv_msg(sock: socket.socket
             ) -> Optional[Tuple[dict, List[bytes]]]:
    """Receive one frame → ``(header, blobs)``; ``None`` on a clean
    close between frames.  Raises :class:`ProtocolError` on anything
    malformed (bad JSON, non-object header, oversized lengths, EOF
    mid-frame)."""
    raw = _recv_exact(sock, _LEN.size, at_boundary=True)
    if raw is None:
        return None
    (hlen,) = _LEN.unpack(raw)
    if hlen > MAX_HEADER:
        raise ProtocolError(f"header length {hlen} exceeds MAX_HEADER")
    try:
        header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"unparseable header: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError(
            f"header must be a JSON object, got "
            f"{type(header).__name__}")
    sizes = header.pop("_blobs", [])
    if (not isinstance(sizes, list)
            or any(not isinstance(s, int) or s < 0 for s in sizes)):
        raise ProtocolError(f"malformed _blobs declaration: {sizes!r}")
    if _LEN.size + hlen + sum(sizes) > MAX_MESSAGE:
        raise ProtocolError("declared message exceeds MAX_MESSAGE")
    blobs = [_recv_exact(sock, s) for s in sizes]
    return header, blobs
