"""Framed array messages over TCP (counterpart of
``sheeprl_tpu/distributed/transport.py``), and the batch digest.

* **Framing**: every message is ``MAGIC | u32 header_len | header JSON | raw array
  bytes``, byte for byte the reference's frame, so either package's client talks to
  either package's server. The header carries the message ``kind``, a small JSON
  ``meta`` dict and the payload's structure: a nested dict/list skeleton in which each
  numpy array is an ``{"__nd__": i}`` placeholder with its dtype and shape. Arrays
  travel as raw bytes after the header, no pickling; a tensor is sent as the numpy
  array of its host copy, and a decoded array is a zero-copy ``np.frombuffer``.
* **Channel**: a connected socket with a thread-safe ``send`` and a blocking, timed or
  polled ``recv``; **Listener** accepts, **connect** retries until the peer listens.
* **Batch digest**: with ``SHEEPRL_TPU_BATCH_DIGEST`` set, a decoupled learner appends
  one sha256 line per consumed batch block to that file, so two runs can show that
  they trained on the same data.

The Sebulba placed-process mode (``sebulba.py``) runs its learner and actors over this
channel.
"""

from __future__ import annotations

import hashlib
import json
import os
import select
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"SBLB"
_HEADER_FMT = "!4sI"  # magic, header length
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)

#: Messages larger than this are rejected at decode time (corrupt frame guard).
MAX_HEADER_BYTES = 16 * 1024 * 1024


class ChannelClosed(ConnectionError):
    """The peer closed the connection (process exit, SIGKILL, network death): a
    routine event, not an error; the peer reconnects on a fresh channel."""


class FramingError(RuntimeError):
    """The byte stream is not a valid frame (bad magic / oversize header)."""


# --------------------------------------------------------------------------- codec
def encode_tree(tree: Any) -> Tuple[Any, List[np.ndarray]]:
    """Replace every numpy array in ``tree`` with an indexed placeholder.

    Returns ``(structure, arrays)`` where ``structure`` is JSON-serializable.
    Scalars (python ints/floats/bools/str/None) pass through inline; numpy
    scalars are converted to python scalars.  Anything else is a hard error —
    the wire format carries data, not objects.
    """
    arrays: List[np.ndarray] = []

    def walk(obj: Any) -> Any:
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        if isinstance(obj, (np.generic,)):
            return obj.item()
        if isinstance(obj, np.ndarray):
            arr = np.ascontiguousarray(obj)
            arrays.append(arr)
            return {
                "__nd__": len(arrays) - 1,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
            }
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if not isinstance(k, str):
                    raise TypeError(f"transport dict keys must be str, got {type(k).__name__}")
                if k == "__nd__":
                    raise TypeError("'__nd__' is a reserved transport key")
                out[k] = walk(v)
            return out
        if isinstance(obj, (list, tuple)):
            return [walk(v) for v in obj]
        # A tensor crosses the wire as the numpy array of its host copy.
        if _is_tensor(obj):
            return walk(obj.detach().cpu().numpy())
        if hasattr(obj, "__array__"):
            return walk(np.asarray(obj))
        raise TypeError(f"transport cannot encode {type(obj).__name__!r}")

    return walk(tree), arrays


def decode_tree(structure: Any, buffers: List[memoryview]) -> Any:
    """Inverse of :func:`encode_tree` over received raw buffers."""

    def walk(obj: Any) -> Any:
        if isinstance(obj, dict):
            if "__nd__" in obj:
                idx = obj["__nd__"]
                arr = np.frombuffer(buffers[idx], dtype=np.dtype(obj["dtype"]))
                return arr.reshape(obj["shape"])
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        return obj

    return walk(structure)


def _pack(kind: str, meta: Optional[Dict[str, Any]], payload: Any) -> List[bytes]:
    structure, arrays = encode_tree(payload)
    header = json.dumps(
        {
            "kind": kind,
            "meta": meta or {},
            "structure": structure,
            "nbytes": [int(a.nbytes) for a in arrays],
        }
    ).encode()
    if len(header) > MAX_HEADER_BYTES:
        raise FramingError(f"header of {len(header)} bytes exceeds MAX_HEADER_BYTES")
    chunks = [struct.pack(_HEADER_FMT, MAGIC, len(header)), header]
    chunks.extend(a.tobytes() for a in arrays)
    return chunks


class Channel:
    """A connected, framed, thread-safe-for-send message channel.

    ``send`` may be called from any thread (one internal lock serializes the
    frame).  ``recv`` must stay on a single consumer thread, like a socket.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover - e.g. AF_UNIX
            pass
        self.bytes_sent = 0
        self.bytes_received = 0

    # ------------------------------------------------------------------ send
    def send(self, kind: str, payload: Any = None, **meta: Any) -> int:
        """Frame and send one message; returns the wire size in bytes.

        Blocking: TCP backpressure is the flow control: a slow reader slows its
        writers down instead of buffering unbounded messages in memory."""
        chunks = _pack(kind, meta, payload)
        n = sum(len(c) for c in chunks)
        with self._send_lock:
            if self._closed:
                raise ChannelClosed("send on closed channel")
            try:
                for c in chunks:
                    # blocking under the lock: it keeps one message's chunks
                    # contiguous on the wire (TCP backpressure is the flow control)
                    self._sock.sendall(c)
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                self._mark_closed()
                raise ChannelClosed(str(e)) from e
            # inside the lock: concurrent senders would lose += updates
            self.bytes_sent += n
        return n

    # ------------------------------------------------------------------ recv
    def _recv_exact(self, n: int) -> memoryview:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                r = self._sock.recv_into(view[got:], n - got)
            except socket.timeout:
                raise TimeoutError(f"recv timed out with {got}/{n} bytes buffered")
            except (ConnectionResetError, OSError) as e:
                self._mark_closed()
                raise ChannelClosed(str(e)) from e
            if r == 0:
                self._mark_closed()
                raise ChannelClosed(f"peer closed with {got}/{n} bytes buffered")
            got += r
        return memoryview(buf)

    def recv(self, timeout: Optional[float] = None) -> Tuple[str, Dict[str, Any], Any]:
        """Receive one message: ``(kind, meta, payload)``.

        ``timeout=None`` blocks; a number raises ``TimeoutError`` past the
        deadline (the frame, once started, is read to completion — a timeout
        can only fire before the first header byte)."""
        if self._closed:
            raise ChannelClosed("recv on closed channel")
        if timeout is not None and not self.poll(timeout):
            raise TimeoutError(f"no message within {timeout}s")
        self._sock.settimeout(None)
        head = self._recv_exact(_HEADER_SIZE)
        magic, header_len = struct.unpack(_HEADER_FMT, head)
        if magic != MAGIC:
            self._mark_closed()
            raise FramingError(f"bad frame magic {bytes(magic)!r}")
        if header_len > MAX_HEADER_BYTES:
            self._mark_closed()
            raise FramingError(f"header of {header_len} bytes exceeds MAX_HEADER_BYTES")
        header = json.loads(bytes(self._recv_exact(header_len)))
        buffers = [self._recv_exact(n) for n in header["nbytes"]]
        self.bytes_received += _HEADER_SIZE + header_len + sum(header["nbytes"])
        payload = decode_tree(header["structure"], buffers)
        return header["kind"], header["meta"], payload

    def poll(self, timeout: float = 0.0) -> bool:
        """True when at least one byte is readable (non-blocking recv gate)."""
        if self._closed:
            return False
        try:
            readable, _, _ = select.select([self._sock], [], [], timeout)
        except (OSError, ValueError):
            return False
        return bool(readable)

    # ------------------------------------------------------------------ state
    def _mark_closed(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass


class Listener:
    """Server-side accept socket; survives any number of peer deaths: a dead
    peer's channel dies with it, the listener stays open, and a reconnecting
    peer gets a fresh channel from a new accept."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, backlog: int = 16):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def accept(self, timeout: Optional[float] = None) -> Channel:
        self._sock.settimeout(timeout)
        try:
            conn, _ = self._sock.accept()
        except socket.timeout:
            raise TimeoutError(f"no connection within {timeout}s")
        conn.settimeout(None)
        return Channel(conn)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass


def connect(
    host: str,
    port: int,
    timeout_s: float = 30.0,
    retry_interval_s: float = 0.1,
) -> Channel:
    """Client-side connect with retry: the peer may still be starting when its
    clients launch, so refusals are retried until ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.settimeout(max(min(retry_interval_s * 10, timeout_s), 0.1))
            sock.connect((host, port))
            sock.settimeout(None)
            return Channel(sock)
        except OSError as e:
            last = e
            sock.close()
            time.sleep(retry_interval_s)
    raise ConnectionError(f"could not reach {host}:{port} within {timeout_s}s: {last}")



# ------------------------------------------------------------------ batch digest
#: When set, learner loops append one sha256 line per consumed batch block to this file.
BATCH_DIGEST_ENV_VAR = "SHEEPRL_TPU_BATCH_DIGEST"

# numpy's name of a bfloat16 array's dtype (ml_dtypes' bfloat16 is a 2-byte void type)
_BF16_DTYPE_STR = "<V2"


def _is_tensor(obj: Any) -> bool:
    """Whether ``obj`` is a torch tensor, without importing torch: a process that never
    imported it (the Sebulba launcher) holds none."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)


def _host_leaf(obj: Any):
    """``(dtype string, shape, bytes)`` of a leaf as a numpy copy of it would have them;
    a tensor is read from its device."""
    if _is_tensor(obj):
        import torch

        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16_DTYPE_STR, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        obj = t.numpy()
    arr = np.ascontiguousarray(np.asarray(obj))
    return arr.dtype.str, arr.shape, arr.tobytes()


def tree_digest(tree: Any) -> str:
    """Order-stable sha256 over every array leaf (dtype, shape and bytes) of a tree of
    dicts, lists and tuples; numpy arrays and tensors hash alike."""
    h = hashlib.sha256()

    def walk(obj: Any, path: str) -> None:
        if isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
        elif obj is None:
            h.update(f"{path}:none".encode())
        else:
            dtype, shape, data = _host_leaf(obj)
            h.update(f"{path}:{dtype}:{shape}".encode())
            h.update(data)

    walk(tree, "")
    return h.hexdigest()


def maybe_digest(tag: str, tree: Any) -> None:
    """Append ``<tag> <sha256>`` for this batch when ``SHEEPRL_TPU_BATCH_DIGEST`` names a
    file; otherwise one environment lookup and nothing else (no copy to the host)."""
    path = os.environ.get(BATCH_DIGEST_ENV_VAR)
    if not path:
        return
    with open(path, "a") as f:
        f.write(f"{tag} {tree_digest(tree)}\n")
