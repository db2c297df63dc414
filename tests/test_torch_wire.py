"""The port's wire (``repro_torch.service.transport``): framing edge cases
and codec negotiation, held against the reference's ``repro.service``.

- Torn and interleaved frames reassemble per connection; an oversized or
  undecodable frame closes only its connection; a handler raising
  ``DropConnection`` severs the client without a reply.
- The negotiation matrix in both directions — a port client against a
  reference server and a reference client against a port server — under
  ``auto``, ``json``, ``tlv`` and ``msgpack``: each settles on the codec
  asked for and the store answers as an in-process one does, bit for bit.
  A legacy (JSON-only) peer falls back to JSON under ``auto``; forcing the
  binary codec on one is a clear error.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest

import repro.service as jservice
import repro_torch.service as tservice
from repro_torch.service.codec import available_codecs, best_binary_codec
from repro_torch.service.transport import (MAX_FRAME_BYTES, _recv_frame,
                                           _recv_msg, _send_msg)
from torch_service_util import assert_same, float_bits

PKGS = {"reference": jservice, "port": tservice}
BINARY = best_binary_codec().name


def _serve(pkg, service=None):
    mod = PKGS[pkg]
    svc = service if service is not None else mod.GroundTruthService()
    server = mod.GroundTruthTCPServer(("127.0.0.1", 0), svc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture
def store_server():
    server = _serve("port")
    yield server
    server.shutdown()


def _frame(payload):
    data = tservice.get_codec("json").encode(payload)
    return struct.pack(">I", len(data)) + data


# ----------------------------------------------------------------- framing

def test_torn_frames_reassemble(store_server):
    sock = socket.create_connection(store_server.server_address[:2],
                                    timeout=10)
    frame = _frame({"op": "version"})
    for i in range(len(frame)):             # byte by byte
        sock.sendall(frame[i:i + 1])
        if i % 7 == 0:
            time.sleep(0.001)
    resp = _recv_msg(sock)
    assert resp == {"ok": True, "version": 0}
    sock.close()


def test_interleaved_partial_sends_stay_isolated(store_server):
    addr = store_server.server_address[:2]
    socks = [socket.create_connection(addr, timeout=10) for _ in range(2)]
    frames = [_frame({"op": "add", "profile": [float(i)] * 3,
                      "workload": f"wl{i}", "sys_config": {"chips": i},
                      "objective": 0.5}) for i in range(2)]
    cut = [len(f) // 2 for f in frames]
    for s, f, c in zip(socks, frames, cut):
        s.sendall(f[:c])
    time.sleep(0.05)
    for s, f, c in zip(socks, frames, cut):
        s.sendall(f[c:])
    versions = sorted(_recv_msg(s)["version"] for s in socks)
    assert versions == [1, 2]
    socks[0].sendall(_frame({"op": "snapshot"}))
    assert _recv_msg(socks[0])["n_entries"] == 2
    for s in socks:
        s.close()


def test_oversized_frame_raises_naming_the_peer():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.sendall(struct.pack(">I", MAX_FRAME_BYTES + 1))
    with pytest.raises(tservice.TransportError,
                       match="10.1.2.3:7077.*exceeds the .*-byte cap"):
        _recv_frame(a, peer="10.1.2.3:7077")
    a.close()
    b.close()


@pytest.mark.parametrize("junk", [struct.pack(">I", 0xFFFFFFFF) + b"junk",
                                  struct.pack(">I", 4) + b"\x00ah!",
                                  _frame([1, 2])],
                         ids=["oversized", "undecodable", "not-a-dict"])
def test_server_closes_only_the_offending_connection(store_server, junk):
    sock = socket.create_connection(store_server.server_address[:2],
                                    timeout=10)
    sock.sendall(junk)
    sock.settimeout(5)
    assert sock.recv(1) == b""                  # closed, no reply
    sock.close()
    with tservice.StoreClient(tservice.SocketTransport(
            *store_server.server_address[:2])) as client:
        assert client.version() == 0            # the serve loop lives on


def test_drop_connection_severs_without_a_reply():
    def handle(req):
        if req.get("op") == "drop":
            raise tservice.DropConnection("mid-request")
        return {"ok": True, "echo": req.get("op")}
    server = tservice.JsonRPCServer(("127.0.0.1", 0), handle)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        t = tservice.SocketTransport(*server.server_address[:2])
        assert t.request({"op": "ping"}) == {"ok": True, "echo": "ping"}
        with pytest.raises(tservice.StoreError, match="unreachable"):
            t.request({"op": "drop"})
        t.close()
        t2 = tservice.SocketTransport(*server.server_address[:2])
        assert t2.request({"op": "again"})["echo"] == "again"
        t2.close()
    finally:
        server.shutdown()


# ------------------------------------------------------------- negotiation

def _store_story(client_mod, transport):
    """Adds, lookups, a batch and a kernel_db round-trip through a client
    of `client_mod`: what it saw, for comparison across wires."""
    client = client_mod.StoreClient(transport)
    rng = np.random.RandomState(9)
    for i in range(6):
        base = np.zeros(5)
        base[i % 2] = 15.0
        client.add(base + rng.randn(5) * 0.1, f"wl{i % 2}",
                   {"chips": 1 + i % 2}, 0.8)
    version = client.add_many([(np.full(5, float(i)), "wl3", {"chips": i},
                                0.6) for i in range(3)])
    probes = [rng.randn(5) * (0.2 if i % 3 else 20.0) for i in range(12)]
    looked = [client.lookup(p) for p in probes] + client.lookup_many(probes)
    rows = client.kernel_put([{"kernel": "rglru", "shape": "B=1",
                               "config": {"chunk": 64}, "objective": 0.5}])
    found = client.kernel_find([{"kernel": "rglru", "shape": "B=1"}])
    snap = client.snapshot()
    client.close()
    return [version, [(float_bits(s), c) for s, c in looked], rows, found,
            snap]


@pytest.mark.parametrize("wire", ["auto", "json", "tlv", "msgpack"])
@pytest.mark.parametrize("client,server", [("port", "reference"),
                                           ("reference", "port")])
def test_negotiation_matrix_across_the_packages(client, server, wire):
    if wire == "msgpack" and "msgpack" not in available_codecs():
        pytest.skip("msgpack is not installed")
    srv = _serve(server)
    try:
        transport = PKGS[client].SocketTransport(
            *srv.server_address[:2], wire=wire)
        assert transport.codec_name == (BINARY if wire == "auto" else wire)
        got = _store_story(PKGS[client], transport)
    finally:
        srv.shutdown()
    local = _store_story(tservice, tservice.InprocTransport(
        tservice.GroundTruthService()))
    assert_same(got, local)


def _legacy_json_server(n_requests=4):
    """A JSON-only peer that errors unknown ops (as a legacy server
    answers the ``_wire`` hello)."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(4)
    listener.settimeout(10)

    def serve():
        try:
            conn, _ = listener.accept()
        except OSError:
            return
        conn.settimeout(10)
        try:
            for _ in range(n_requests):
                req = _recv_msg(conn)
                if req.get("op") == "version":
                    _send_msg(conn, {"ok": True, "version": 0})
                else:
                    _send_msg(conn, {"ok": False, "error":
                                     f"unknown op {req.get('op')!r}"})
        except (ConnectionError, OSError):
            pass
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return listener, listener.getsockname()[1]


def test_auto_falls_back_to_json_on_a_legacy_peer():
    listener, port = _legacy_json_server()
    t = tservice.SocketTransport("127.0.0.1", port, wire="auto")
    assert t.codec_name == "json"
    assert t.request({"op": "version"}) == {"ok": True, "version": 0}
    t.close()
    listener.close()


@pytest.mark.parametrize("wire", ["binary", "tlv"])
def test_forcing_binary_on_a_legacy_peer_is_a_clear_error(wire):
    listener, port = _legacy_json_server(n_requests=1)
    with pytest.raises(tservice.TransportError,
                       match="declined wire codec .*supports: \\['json'\\]"):
        tservice.SocketTransport("127.0.0.1", port, wire=wire)
    listener.close()


def test_generic_ok_responder_does_not_flip_the_wire():
    """A peer that answers every op with a bare {"ok": true} has not
    agreed to a codec: the hello needs the codec's name echoed back."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(10)

    def serve():
        try:
            conn, _ = listener.accept()
        except OSError:
            return
        conn.settimeout(10)
        try:
            while True:
                _recv_msg(conn)
                _send_msg(conn, {"ok": True})
        except (ConnectionError, OSError):
            pass
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    t = tservice.SocketTransport("127.0.0.1", listener.getsockname()[1],
                                 wire="auto")
    assert t.codec_name == "json"
    assert t.request({"op": "anything"})["ok"]
    t.close()
    listener.close()


def test_connect_retries_a_late_server_and_bounds_a_dead_one():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    holder = {}

    def start_late():
        time.sleep(0.3)
        svc = tservice.GroundTruthService()
        holder["srv"] = tservice.serve(svc, port=port, background=True)
    threading.Thread(target=start_late, daemon=True).start()
    t = tservice.SocketTransport("127.0.0.1", port, connect_retries=6,
                                 retry_backoff_s=0.1)
    assert t.request({"op": "version"})["ok"]
    t.close()
    holder["srv"].shutdown()
    t0 = time.monotonic()
    with pytest.raises(tservice.TransportError, match="after 2 attempt"):
        tservice.SocketTransport("127.0.0.1", port, timeout=0.5,
                                 connect_retries=1, retry_backoff_s=0.05)
    assert time.monotonic() - t0 < 5.0
