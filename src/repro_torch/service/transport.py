"""Transports for ``GroundTruthService`` + the ``StoreClient`` facade: the
counterpart of ``repro.service.transport``.

``StoreClient`` exposes the same surface PipeTune already speaks to a bare
``GroundTruth`` — ``lookup`` / ``add`` / ``hits`` / ``misses`` — over any
transport:

* ``InprocTransport`` — request dicts go straight into
  ``GroundTruthService.handle`` (zero serialization; the default for sim
  runs and tests).
* ``SocketTransport`` — length-prefixed frames over TCP (4-byte big-endian
  length + payload) to any ``JsonRPCServer`` host. Connections start in
  JSON and may negotiate a binary codec (msgpack, or the stdlib TLV
  fallback — see ``repro_torch.service.codec``) via a ``_wire`` hello; peers
  that don't understand the hello just error it and the client stays on
  JSON, so old and new processes interoperate freely.

Hot-path lookups stay local: the client caches the store's
``CentroidModel`` (centroids + normalization + radius + per-cluster best
configs) and evaluates profiles against it with the *same* arithmetic the
server would use. Every service response piggybacks the current store
``version``, so in the default ``sync="piggyback"`` mode a cache-fresh
lookup costs **zero** round-trips — the cache is re-fetched only when a
piggybacked version shows a refit moved past it (``sync="ping"`` restores
the legacy one-``version``-RPC-per-lookup behaviour for clients that need
to observe other writers' refits without issuing any traffic of their
own). All codecs round-trip floats bit-exactly, so a socket client's
hit/miss pattern is bit-identical to an in-process run — the acceptance
property the tests assert.

``JsonRPCServer`` (the name predates the binary codecs; it hosts any
``handle(dict) -> dict`` callable) is a selector-based multiplexing loop:
one I/O thread owns every connection, complete frames are dispatched to a
small handler pool, and responses flow back through per-connection
outboxes — no thread-per-connection. A handler may raise
``DropConnection`` to sever the client without replying (the
fault-injection hook the tests use to model mid-batch drops).

The frames, the ``_wire`` hello and every payload are the reference's, so
a client of either package talks to a server of the other. A traced
connection (``StoreClient.enable_trace``, ``repro_torch.obs.forward``)
adds the reference's ``_trace`` request metadata to public ops only, and
the client emits an ``RpcCompleted`` receipt per store round trip; an
untraced request's bytes are the reference's.
"""
from __future__ import annotations

import selectors
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.groundtruth import CentroidModel
from repro_torch.service.codec import (Codec, CodecError, available_codecs,
                                       get_codec, plain)
from repro_torch.service.service import GroundTruthService

__all__ = ["StoreClient", "StoreError", "TransportError", "DropConnection",
           "InprocTransport", "SocketTransport", "JsonRPCServer",
           "GroundTruthTCPServer", "serve", "MAX_FRAME_BYTES"]

# A corrupt 4-byte length prefix must not trigger an arbitrary-size
# allocation: frames above this are a protocol violation, not a payload.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_JSON = get_codec("json")


class TransportError(RuntimeError):
    """A transport-level failure (connect, send, receive, bad frame)."""


class StoreError(TransportError):
    """A store request failed (server error or broken transport)."""


class DropConnection(Exception):
    """Raised by an RPC handler to close the client connection without
    sending a response — simulates a peer dying mid-request (used by the
    wire tests to model mid-batch connection drops)."""


# ---------------------------------------------------------------------------
# transports: anything with request(dict) -> dict and close()
# ---------------------------------------------------------------------------

class InprocTransport:
    """Direct dispatch into a service living in this process."""

    def __init__(self, service: GroundTruthService):
        self.service = service

    def request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return self.service.handle(req)

    def close(self):
        pass


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into one preallocated buffer (no
    per-chunk bytes reallocation)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            raise ConnectionError("connection closed mid-frame"
                                  if got else "connection closed")
        got += k
    return buf


def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_frame(sock: socket.socket, max_frame: int = MAX_FRAME_BYTES,
                peer: str = "peer") -> bytearray:
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > max_frame:
        raise TransportError(
            f"frame of {n} bytes from {peer} exceeds the {max_frame}-byte "
            "cap — corrupt length prefix, or a non-repro peer on this port")
    return _recv_exact(sock, n)


def _send_msg(sock: socket.socket, payload: dict,
              codec: Codec = _JSON) -> None:
    _send_frame(sock, codec.encode(payload))


def _recv_msg(sock: socket.socket, codec: Codec = _JSON,
              max_frame: int = MAX_FRAME_BYTES, peer: str = "peer") -> dict:
    return codec.decode(bytes(_recv_frame(sock, max_frame, peer)))


_SAME_AS_CONNECT = object()


class SocketTransport:
    """One persistent length-prefixed connection; thread-safe.

    ``timeout`` bounds the connect (and, by default, every request);
    ``request_timeout`` overrides the per-request bound — pass ``None`` for
    fully blocking requests (remote workers: a trial legitimately takes
    longer than any sane connect timeout). A refused/failed connect is
    retried ``connect_retries`` times with exponential backoff starting at
    ``retry_backoff_s``, so servers that come up a moment after their
    clients don't kill the run.

    ``wire`` picks the payload codec: ``"auto"`` (default) offers the best
    binary codec and silently stays on JSON if the peer declines (legacy
    servers error the hello, which *is* declining); ``"json"`` skips the
    hello; a concrete name (``"binary"``/``"msgpack"``/``"tlv"``) demands
    that codec and raises ``TransportError`` if the peer can't speak it.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 7077,
                 timeout: float = 30.0, connect_retries: int = 3,
                 retry_backoff_s: float = 0.2,
                 request_timeout: Any = _SAME_AS_CONNECT,
                 wire: str = "auto", max_frame: int = MAX_FRAME_BYTES):
        self.addr = (host, port)
        self.max_frame = max_frame
        self._codec = _JSON
        # distributed-tracing context: once the obs_trace hello succeeds
        # (repro_torch.obs.forward.propagate_trace) every request carries
        # the trace id as `_trace` metadata; services ignore unknown keys,
        # so this is free interop with untraced/legacy peers
        self.trace: Optional[str] = None
        self._sock = self._connect(timeout, connect_retries, retry_backoff_s)
        if request_timeout is not _SAME_AS_CONNECT:
            self._sock.settimeout(request_timeout)
        # request/response over tiny messages: Nagle only adds latency
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        if wire not in (None, "json"):
            self._negotiate(wire)

    @property
    def codec_name(self) -> str:
        return self._codec.name

    def _connect(self, timeout: float, retries: int,
                 backoff_s: float) -> socket.socket:
        delay = backoff_s
        for attempt in range(retries + 1):
            try:
                return socket.create_connection(self.addr, timeout=timeout)
            except OSError as e:
                if attempt == retries:
                    raise TransportError(
                        f"could not connect to {self.addr[0]}:{self.addr[1]} "
                        f"after {retries + 1} attempt(s): {e}") from None
                time.sleep(delay)
                delay *= 2

    def _negotiate(self, wire: str) -> None:
        want = get_codec("binary" if wire == "auto" else wire)
        if want.name == "json":
            return
        resp = self.request({"op": "_wire", "codec": want.name})
        # the peer must echo the codec name back: a service that answers
        # unknown ops with a generic {"ok": true} must not flip the wire
        if resp.get("ok") and resp.get("codec") == want.name:
            self._codec = want
        elif wire != "auto":
            raise TransportError(
                f"peer at {self.addr[0]}:{self.addr[1]} declined wire codec "
                f"{want.name!r}: {resp.get('error', 'unsupported')} "
                f"(peer supports: {resp.get('supported', ['json'])})")
        # auto: peer predates the hello or lacks the codec — stay on JSON

    def request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        peer = f"{self.addr[0]}:{self.addr[1]}"
        if (self.trace is not None and "_trace" not in req
                and not str(req.get("op", "")).startswith("_")):
            req = {**req, "_trace": self.trace}
        try:
            with self._lock:
                _send_frame(self._sock, self._codec.encode(req))
                return self._codec.decode(
                    bytes(_recv_frame(self._sock, self.max_frame, peer)))
        except (OSError, ConnectionError) as e:
            raise StoreError(f"peer at {peer} unreachable: {e}") from None
        except CodecError as e:
            raise StoreError(f"peer at {peer} sent an undecodable "
                             f"{self._codec.name} frame: {e}") from None

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class StoreClient:
    """GroundTruth-compatible client over a transport (see module doc).

    ``hits``/``misses`` count this client's own lookups — what a
    ``JobResult`` reports for the job that used this client; the server
    keeps aggregate counters across all clients (``snapshot()``).

    ``sync="piggyback"`` (default): every response already carries the
    store version, so a lookup whose cached model matches the last
    version seen is answered locally with **no** round-trip. A read-only
    client that never issues *any* RPC can therefore miss other writers'
    refits until its next request of any kind (its own adds/refits/
    ``version()`` calls all refresh it); single-experiment runs are never
    stale because the experiment is the only writer. ``sync="ping"``
    restores the legacy version-RPC-per-lookup behaviour.
    """

    def __init__(self, transport, sync: str = "piggyback"):
        if sync not in ("piggyback", "ping"):
            raise ValueError(f"sync must be 'piggyback' or 'ping', "
                             f"got {sync!r}")
        self.transport = transport
        self.sync = sync
        self._lock = threading.Lock()
        self._model: Optional[CentroidModel] = None
        self._model_version: Optional[int] = None
        self._known_version: Optional[int] = None
        self.hits = 0
        self.misses = 0
        # tracing: set by enable_trace; every RPC then emits RpcCompleted
        # on this bus so store stalls show up in the merged timeline
        self.bus = None
        addr = getattr(transport, "addr", None)
        self.peer = (f"store@{addr[0]}:{addr[1]}"
                     if isinstance(addr, tuple) and len(addr) == 2
                     else "store@inproc")

    # -------------------------------------------------------------- plumbing
    def _request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        bus = self.bus
        if bus is not None and bus.enabled:
            t0 = time.monotonic()
            resp = self.transport.request(req)
            dt = time.monotonic() - t0
            from repro_torch.obs.events import RpcCompleted
            op = str(req.get("op", ""))
            n = (len(req.get("requests") or ()) if op == "batch" else 1)
            bus.emit(RpcCompleted(op=op, peer=self.peer, duration_s=dt,
                                  overhead_s=dt, n=max(1, n)))
        else:
            resp = self.transport.request(req)
        if not resp.get("ok"):
            raise StoreError(resp.get("error", "store request failed"))
        v = resp.get("version")
        if v is not None:
            with self._lock:
                self._known_version = v
        return resp

    def enable_trace(self, trace_id: str, collector: Optional[str] = None,
                     bus=None) -> bool:
        """Join this client's store traffic to a distributed trace: emit
        ``RpcCompleted`` per round-trip on ``bus`` and (for TCP stores)
        send the ``obs_trace`` hello so the *service* tags + forwards its
        own events. In-process stores share our process, so their service
        is simply pointed at the traced bus. False = legacy peer."""
        from repro_torch.obs.events import get_bus
        self.bus = bus if bus is not None else get_bus()
        if isinstance(self.transport, InprocTransport):
            if getattr(self.transport.service, "bus", None) is not None:
                self.transport.service.bus = self.bus
            return True
        from repro_torch.obs.forward import propagate_trace
        return propagate_trace(self.transport, trace_id,
                               collector=collector, proc=self.peer,
                               bus=self.bus)

    def version(self) -> int:
        return self._request({"op": "version"})["version"]

    def _model_at_version(self, version: int) -> Optional[CentroidModel]:
        """The cached centroid model, re-fetched iff `version` moved past
        the cache."""
        with self._lock:
            if self._model_version == version:
                return self._model
        return self._fetch_model()

    def _fetch_model(self) -> Optional[CentroidModel]:
        snap = self._request({"op": "snapshot"})
        with self._lock:
            self._model = (None if snap["model"] is None
                           else CentroidModel.from_payload(snap["model"]))
            self._model_version = snap["version"]
            return self._model

    def _fresh_model(self) -> Optional[CentroidModel]:
        """The centroid model at the latest version this client must
        honour — zero RPCs when piggybacked versions say the cache is
        already current."""
        if self.sync == "ping":
            return self._model_at_version(self.version())
        with self._lock:
            if (self._known_version is not None
                    and self._model_version == self._known_version):
                return self._model
        return self._fetch_model()

    # ------------------------------------------------------- store interface
    def lookup(self, profile: np.ndarray) -> Tuple[float, Optional[dict]]:
        model = self._fresh_model()
        score, cfg = (0.0, None) if model is None else model.evaluate(profile)
        with self._lock:
            if cfg is None:
                self.misses += 1
            else:
                self.hits += 1
        return score, cfg

    def lookup_many(self, profiles: Sequence[np.ndarray]
                    ) -> List[Tuple[float, Optional[dict]]]:
        """Batched ``lookup``: one model-freshness check, then one
        vectorized evaluation pass. Bit-identical to calling ``lookup``
        per profile (``CentroidModel.evaluate_many`` reduces with the
        same per-row arithmetic as ``evaluate``)."""
        profiles = list(profiles)
        if not profiles:
            return []
        model = self._fresh_model()
        if model is None:
            results = [(0.0, None) for _ in profiles]
        else:
            results = model.evaluate_many(profiles)
        n_hit = sum(1 for _, cfg in results if cfg is not None)
        with self._lock:
            self.hits += n_hit
            self.misses += len(results) - n_hit
        return results

    def add(self, profile: np.ndarray, workload: str, sys_config: dict,
            objective: float, refit: bool = True) -> int:
        resp = self._request({
            "op": "add",
            "profile": np.asarray(profile, np.float64).tolist(),
            "workload": workload, "sys_config": plain(sys_config),
            "objective": float(objective), "refit": refit})
        return resp["version"]

    def add_many(self, items: Sequence[Tuple[np.ndarray, str, dict, float]],
                 refit: bool = True) -> int:
        """Add many entries in one round-trip (a ``batch`` of journaled
        adds with a single journal flush), refitting once at the end."""
        reqs: List[Dict[str, Any]] = [{
            "op": "add",
            "profile": np.asarray(p, np.float64).tolist(),
            "workload": w, "sys_config": plain(c),
            "objective": float(obj), "refit": False}
            for p, w, c, obj in items]
        if refit and reqs:
            reqs.append({"op": "refit"})
        resp = self._request({"op": "batch", "requests": reqs})
        for sub in resp["results"]:
            if not sub.get("ok"):
                raise StoreError(sub.get("error", "batched add failed"))
        return resp["version"]

    def refit(self) -> int:
        return self._request({"op": "refit"})["version"]

    def snapshot(self) -> Dict[str, Any]:
        return self._request({"op": "snapshot"})

    # ------------------------------------------------------- kernel find-db
    @staticmethod
    def _kernel_row(row: Dict[str, Any]) -> Dict[str, Any]:
        out = {"kernel": str(row["kernel"]), "shape": str(row["shape"]),
               "hardware": str(row.get("hardware", "any"))}
        if "config" in row:
            out["config"] = plain(row["config"])
            out["objective"] = (None if row.get("objective") is None
                                else float(row["objective"]))
        return out

    def kernel_put(self, entries: Sequence[Dict[str, Any]]) -> int:
        """Persist tuned kernel configs (``{kernel, shape, config,
        hardware?, objective?}`` rows) in one journaled round-trip;
        returns the server's total find-db entry count."""
        resp = self._request({
            "op": "kernel_db",
            "puts": [self._kernel_row(e) for e in entries]})
        return resp["n_kernel_entries"]

    def kernel_find(self, queries: Sequence[Dict[str, Any]]
                    ) -> List[Optional[dict]]:
        """Best-known config (or None) for each ``{kernel, shape,
        hardware?}`` query, answered in order from one round-trip."""
        resp = self._request({
            "op": "kernel_db",
            "queries": [self._kernel_row(q) for q in queries]})
        return resp["configs"]

    def kernel_export(self) -> List[dict]:
        """Every find-db row — the golden-table export path."""
        resp = self._request({"op": "kernel_db", "export": True})
        return resp["entries"]

    def close(self):
        self.transport.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# TCP server: selector-based multiplexing loop + bounded handler pool
# ---------------------------------------------------------------------------

class _Conn:
    """Per-connection state owned by the server's I/O thread (buffers and
    codec) and shared with handler threads under the server lock
    (``pending``/``busy``/``outbox``/``drop``)."""

    __slots__ = ("sock", "peer", "codec", "buf", "pending", "busy",
                 "outbox", "drop", "alive", "want_write")

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.peer = peer
        self.codec: Codec = _JSON
        self.buf = bytearray()
        self.pending: deque = deque()    # decoded requests awaiting a slot
        self.busy = False                # a handler is in flight
        self.outbox: deque = deque()     # encoded frames awaiting send
        self.drop = False                # sever without responding
        self.alive = True
        self.want_write = False          # EVENT_WRITE currently registered


class JsonRPCServer:
    """Serve any ``handle(dict) -> dict`` callable over the length-prefixed
    framing — the shared substrate under the ground-truth store server, the
    trial worker server, the coordinator, and the obs endpoint. Port 0
    binds an ephemeral port (read it back from ``server_address``).

    One selector thread (the caller of ``serve_forever``) owns all socket
    I/O; complete request frames are dispatched FIFO-per-connection to a
    bounded ``ThreadPoolExecutor`` (``handlers`` wide), so one slow
    handler never blocks other connections and a storm of connections
    never spawns a storm of threads. The ``_wire`` hello is answered
    inline by the I/O thread: the reply goes out in the old codec, then
    the connection switches, so JSON-only peers interoperate untouched.
    """

    def __init__(self, address: Tuple[str, int], rpc_handle,
                 handlers: int = 8, max_frame: int = MAX_FRAME_BYTES):
        self.rpc_handle = rpc_handle
        self.max_frame = max_frame
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(address)
        self._listener.listen(128)
        self._listener.setblocking(False)
        self.server_address = self._listener.getsockname()
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._pool = ThreadPoolExecutor(max_workers=handlers,
                                        thread_name_prefix="rpc")
        self._lock = threading.Lock()
        self._conns: set = set()
        self._dirty: set = set()         # conns with handler-thread updates
        self._shutdown_flag = False
        self._running = threading.Event()
        self._done = threading.Event()
        self._cleaned = False

    # ------------------------------------------------------------- lifecycle
    def serve_forever(self):
        if self._shutdown_flag:
            return
        self._running.set()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._shutdown_flag:
                for key, mask in self._sel.select(timeout=0.5):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wake()
                    else:
                        conn: _Conn = key.data
                        if mask & selectors.EVENT_READ:
                            self._on_readable(conn)
                        if conn.alive and mask & selectors.EVENT_WRITE:
                            self._on_writable(conn)
                self._apply_dirty()
        finally:
            self._cleanup()

    def shutdown(self):
        """Stop the serve loop and release sockets; blocking, idempotent."""
        self._shutdown_flag = True
        self._wake()
        if self._running.is_set():
            self._done.wait(timeout=10.0)
        else:
            self._cleanup()

    def _cleanup(self):
        with self._lock:
            if self._cleaned:
                return
            self._cleaned = True
            conns = list(self._conns)
            self._conns.clear()
            self._dirty.clear()
        for conn in conns:
            conn.alive = False
            try:
                conn.sock.close()
            except OSError:
                pass
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        self._sel.close()
        self._pool.shutdown(wait=False)
        self._done.set()

    def _wake(self):
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # ------------------------------------------------------------- I/O thread
    def _accept(self):
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, f"{addr[0]}:{addr[1]}")
            with self._lock:
                self._conns.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drain_wake(self):
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _apply_dirty(self):
        """Pick up handler-thread updates: pending sends and drops."""
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
        for conn in dirty:
            if not conn.alive:
                continue
            if conn.drop:
                self._close_conn(conn)
            elif conn.outbox:
                self._on_writable(conn)

    def _close_conn(self, conn: _Conn):
        conn.alive = False
        with self._lock:
            self._conns.discard(conn)
            self._dirty.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _on_readable(self, conn: _Conn):
        try:
            chunk = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not chunk:
            self._close_conn(conn)
            return
        conn.buf += chunk
        while conn.alive and len(conn.buf) >= 4:
            (n,) = struct.unpack_from(">I", conn.buf)
            if n > self.max_frame:          # corrupt prefix / foreign peer
                self._close_conn(conn)
                return
            if len(conn.buf) < 4 + n:
                break
            frame = bytes(conn.buf[4:4 + n])
            del conn.buf[:4 + n]
            try:
                req = conn.codec.decode(frame)
            except CodecError:
                self._close_conn(conn)
                return
            if not isinstance(req, dict):
                self._close_conn(conn)
                return
            self._on_request(conn, req)

    def _on_request(self, conn: _Conn, req: dict):
        if req.get("op") == "_wire":
            # answered inline in the old codec, then the connection flips
            name = req.get("codec")
            try:
                new = get_codec(name) if name != "binary" else None
            except CodecError:
                new = None
            if new is None:
                resp = {"ok": False,
                        "error": f"unsupported wire codec {name!r}",
                        "supported": list(available_codecs())}
            else:
                resp = {"ok": True, "codec": new.name}
            try:
                data = conn.codec.encode(resp)
            except CodecError:
                # the hello answer cannot be encoded in the CURRENT codec:
                # dropping beats leaving the peer blocked on a reply and
                # beats killing the selector thread for everyone else
                self._close_conn(conn)
                return
            self._queue_frame(conn, data)
            if new is not None:
                conn.codec = new
            return
        with self._lock:
            if conn.busy:
                conn.pending.append(req)
                return
            conn.busy = True
        self._pool.submit(self._run_handler, conn, req)

    def _on_writable(self, conn: _Conn):
        with self._lock:
            outbox = conn.outbox
        while outbox:
            data = outbox[0]
            try:
                sent = conn.sock.send(data)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_conn(conn)
                return
            if sent < len(data):
                outbox[0] = data[sent:]
                break
            outbox.popleft()
        want = bool(outbox)
        if want != conn.want_write:
            conn.want_write = want
            events = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if want else 0)
            try:
                self._sel.modify(conn.sock, events, conn)
            except (KeyError, ValueError, OSError):
                self._close_conn(conn)

    def _queue_frame(self, conn: _Conn, data: bytes):
        with self._lock:
            conn.outbox.append(struct.pack(">I", len(data)) + data)
        self._on_writable(conn)

    # --------------------------------------------------------- handler threads
    def _run_handler(self, conn: _Conn, req: dict):
        drop = False
        try:
            resp = self.rpc_handle(req)
        except DropConnection:
            resp, drop = None, True
        except Exception as e:           # noqa: BLE001 — wire boundary
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if not drop:
            try:
                data = conn.codec.encode(resp)
            except CodecError as e:
                # a str-only error dict encodes under every wire codec
                data = conn.codec.encode(  # lint: disable=EXC001
                    {"ok": False, "error": f"CodecError: {e}"})
            framed = struct.pack(">I", len(data)) + data
        with self._lock:
            if not conn.alive:
                return
            if drop:
                conn.drop = True
                conn.pending.clear()
                conn.busy = False
            else:
                conn.outbox.append(framed)
                if conn.pending:
                    nxt = conn.pending.popleft()
                    self._pool.submit(self._run_handler, conn, nxt)
                else:
                    conn.busy = False
            self._dirty.add(conn)
        self._wake()


class GroundTruthTCPServer(JsonRPCServer):
    """Serve one ``GroundTruthService`` to many socket clients."""

    def __init__(self, address: Tuple[str, int], service: GroundTruthService):
        super().__init__(address, service.handle)
        self.service = service


def serve(service: GroundTruthService, host: str = "127.0.0.1",
          port: int = 7077, background: bool = False) -> GroundTruthTCPServer:
    """Run a TCP store server; ``background=True`` serves from a daemon
    thread and returns immediately (tests, co-located services)."""
    server = GroundTruthTCPServer((host, port), service)
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    else:
        server.serve_forever()
    return server
