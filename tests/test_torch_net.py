"""The port's wire layer (``repro_torch.net``) against the JAX package's
``repro.net``, on the CPU.

  * the stdlib codec (``repro_torch.codec``) writes ``msgpack.packb(obj,
    use_bin_type=True)``'s bytes for every type a frame holds, across the
    size boundaries, and decodes strictly (``CodecError`` and nothing else);
  * request, response and error frames (seeded cases, unicode ids, n from
    1 to 64, ``retry_after_ms`` None, int and float) encode byte for byte
    as ``repro.net.protocol``'s, and each package decodes the other's; the
    malformed and structurally invalid frames of tests/test_net.py raise
    ``ProtocolError`` in the port, and random corruptions raise nothing else;
  * the port's clients against a scripted HTTP stub (retries, backoff,
    deadlines, connection reuse);
  * the port's ``NetServer`` on the CPU lane: answers bitwise equal to
    ``Server.submit``, the status mapping (400/404/405/413/429/503),
    /healthz and /slo, a swap under wire load; a JAX ``NetClient`` against
    it and the port's ``NetClient`` against a JAX ``NetServer``, each
    bitwise the serving package's ``Server.submit``; and
    ``python -m repro_torch.net.server`` end to end, refusing to start
    without a GPU unless told ``--device cpu``.

The ``cuda`` twin holds the wire golden property on the card.
"""
from __future__ import annotations

import asyncio
import contextlib
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import msgpack
import numpy as np
import pytest
import torch

from repro.net import protocol as jprotocol
from repro_torch import api
from repro_torch.codec import CodecError, packb, unpackb
from repro_torch.data.spatial import e3sm_like_field
from repro_torch.net import protocol
from repro_torch.net.client import (
    AsyncNetClient,
    DeadlineExceeded,
    NetClient,
    RetriesExhausted,
    RetryPolicy,
    ServerError,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the codec alone
# ---------------------------------------------------------------------------

_BOUNDARY_INTS = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                  -1, -31, -32, -33, -127, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
_SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("value", [
    *_BOUNDARY_INTS,
    0.0, -1.5, 1e300, float("inf"), 2.5e-320, None, True, False,
    *("x" * n for n in _SIZES), "é☃𝄞", *(b"\x00\xff" * (n // 2) + b"z" * (n % 2) for n in _SIZES),
    *([7] * n for n in _SIZES), (1, "a", None), *({f"k{i}": i for i in range(n)} for n in (0, 15, 16)),
    {"nested": [{"a": [1, -1, 1.25, b"x", None, True]}], "": {}},
], ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__") else v)[:12])
def test_codec_writes_msgpack_bytes_and_reads_them_back(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert packb(value) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=True)


def test_codec_map_of_65536_entries_and_unsupported_types():
    big = {str(i): i for i in range(65536)}
    assert packb(big) == msgpack.packb(big, use_bin_type=True)
    assert unpackb(packb(big)) == big
    for bad in ({1, 2}, object(), np.float32(1.0), 2**64, -2**63 - 1):
        with pytest.raises((TypeError, OverflowError)):
            packb(bad)


@pytest.mark.parametrize("buf,why", [
    (b"", "empty"),
    (b"\xc1", "never-used code"),
    (b"\xd4\x01\x02", "fixext"),
    (b"\xc7\x01\x05\x00", "ext8"),
    (b"\x92\x01", "truncated array"),
    (b"\xa3ab", "truncated str"),
    (b"\xcd\x01", "truncated uint16"),
    (b"\x01\x02", "trailing byte"),
    (b"\x81\x01\x02", "int map key"),
    (b"\x81\xc4\x01k\x02", "bin map key"),
    (b"\xa2\xff\xfe", "invalid utf-8"),
    (b"\xdd\xff\xff\xff\xff", "array longer than the buffer"),
    (b"\x91" * 2000 + b"\x00", "nesting"),
])
def test_codec_decodes_strictly(buf, why):
    with pytest.raises(CodecError):
        unpackb(buf)


# ---------------------------------------------------------------------------
# frames: byte-for-byte with the JAX package, both ways
# ---------------------------------------------------------------------------

_IDS = ["r", "req-1", "ünïcødé-☃", "𝄞" * 32, "x" * 128]


def _frames(seed: int):
    """(port frame, JAX frame) pairs of every kind from one seed."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 65))
    rid = _IDS[seed % len(_IDS)]
    pts = rng.uniform(-180, 180, (n, 2))
    mean, var = rng.normal(size=n).astype(np.float32), rng.uniform(0, 3, n).astype(np.float32)
    timing = tuple(float(t) for t in rng.uniform(0, 50, 3))
    version = int(rng.integers(0, 2**40))
    retry = [None, float(rng.uniform(0, 5000)), 50.0][seed % 3]
    code = jprotocol.ERROR_CODES[seed % len(jprotocol.ERROR_CODES)]
    return [
        (protocol.PredictRequest.from_points(rid, pts),
         jprotocol.PredictRequest.from_points(rid, pts)),
        (protocol.PredictResponse.from_arrays(rid, mean, var, server_version=version,
                                              timing_ms=timing),
         jprotocol.PredictResponse.from_arrays(rid, mean, var, server_version=version,
                                               timing_ms=timing)),
        (protocol.ErrorFrame(rid, code, f"message {seed} ✓", retry_after_ms=retry),
         jprotocol.ErrorFrame(rid, code, f"message {seed} ✓", retry_after_ms=retry)),
    ]


def _same(port_frame, jax_frame) -> bool:
    return (type(port_frame).__name__ == type(jax_frame).__name__
            and [getattr(port_frame, f) for f in port_frame.__dataclass_fields__]
            == [getattr(jax_frame, f) for f in jax_frame.__dataclass_fields__])


@pytest.mark.parametrize("seed", range(12))
def test_frames_encode_as_the_jax_package_encodes_and_decode_both_ways(seed):
    for tf, jf in _frames(seed):
        assert tf.encode() == jf.encode()
        assert _same(protocol.decode_frame(jf.encode()), jf)
        assert _same(jprotocol.decode_frame(tf.encode()), tf)
        assert protocol.decode_frame(tf.encode()) == tf


def test_integer_retry_hint_on_the_wire_decodes_as_jax_decodes():
    body = msgpack.packb({"v": 1, "kind": "error", "request_id": "", "code": "shed",
                          "message": "full", "retry_after_ms": 50}, use_bin_type=True)
    got, want = protocol.decode_frame(body), jprotocol.decode_frame(body)
    assert got.retry_after_ms == want.retry_after_ms == 50.0
    assert isinstance(got.retry_after_ms, float) and got.status == 429


def test_every_error_code_pins_the_jax_status():
    assert protocol.STATUS_FOR_CODE == jprotocol.STATUS_FOR_CODE
    assert protocol.ERROR_CODES == jprotocol.ERROR_CODES
    for code in protocol.ERROR_CODES:
        assert protocol.ErrorFrame("", code, "x").status == protocol.STATUS_FOR_CODE[code]


def _valid_frame_dict():
    return msgpack.unpackb(
        protocol.PredictRequest.from_points("r", np.zeros((2, 2))).encode(), raw=False
    )


@pytest.mark.parametrize("mutate,why", [
    (lambda buf: buf[:-3], "truncated"),
    (lambda buf: buf + b"xx", "trailing bytes"),
    (lambda buf: b"\xc1garbage", "garbage"),
    (lambda buf: b"", "empty"),
])
def test_malformed_bytes_raise_protocol_error(mutate, why):
    buf = protocol.PredictRequest.from_points("r", np.zeros((3, 2))).encode()
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_frame(mutate(buf))


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d.update(v=99), "version mismatch"),
    (lambda d: d.pop("v"), "missing protocol version"),
    (lambda d: d.update(kind="telemetry"), "unknown frame kind"),
    (lambda d: d.update(extra=1), "key set mismatch"),
    (lambda d: d.pop("n"), "key set mismatch"),
    (lambda d: d.update(n="2"), "must be an int"),
    (lambda d: d.update(n=5), "must be .* bytes"),
    (lambda d: d.update(request_id=""), "non-empty str"),
])
def test_structurally_invalid_frames_raise_protocol_error(mutate, match):
    d = _valid_frame_dict()
    mutate(d)
    with pytest.raises(protocol.ProtocolError, match=match):
        protocol.decode_frame(msgpack.packb(d, use_bin_type=True))


def test_non_map_and_non_str_key_frames_raise():
    with pytest.raises(protocol.ProtocolError, match="msgpack map"):
        protocol.decode_frame(msgpack.packb([1, 2, 3]))
    with pytest.raises(protocol.ProtocolError, match="undecodable"):
        protocol.decode_frame(msgpack.packb({1: 2}))


def test_random_corruptions_raise_protocol_error_only():
    rng = random.Random(0)
    frames = [tf.encode() for seed in range(3) for tf, _ in _frames(seed)]
    for _ in range(1500):
        buf = bytearray(rng.choice(frames))
        op = rng.randrange(3)
        if op == 0:
            del buf[rng.randrange(len(buf)):]
        elif op == 1:
            for _ in range(rng.randint(1, 4)):
                buf[rng.randrange(len(buf))] = rng.randrange(256)
        else:
            buf[rng.randrange(len(buf))] = rng.choice([0xC1, 0xD4, 0xC7, 0xDD, 0xDF, 0x81])
        try:
            protocol.decode_frame(bytes(buf))
        except protocol.ProtocolError:
            pass


def test_construction_validation():
    with pytest.raises(protocol.ProtocolError, match=r"\(n >= 1, 2\)"):
        protocol.PredictRequest.from_points("r", np.zeros((0, 2)))
    with pytest.raises(protocol.ProtocolError, match="non-empty str"):
        protocol.PredictRequest.from_points("", np.zeros((1, 2)))
    with pytest.raises(protocol.ProtocolError, match="code must be one of"):
        protocol.ErrorFrame("", "nope", "x")
    with pytest.raises(protocol.ProtocolError, match="equal-length"):
        protocol.PredictResponse.from_arrays("r", np.zeros(3), np.zeros(4), server_version=0,
                                             timing_ms=(0.0, 0.0, 0.0))


# ---------------------------------------------------------------------------
# clients against a scripted server
# ---------------------------------------------------------------------------


class ScriptedHTTP:
    """A plain-socket HTTP stub answering POST /predict with a scripted
    (status, body, headers) sequence; the last entry repeats."""

    def __init__(self, script):
        self.script = list(script)
        self.hits = 0
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,), daemon=True).start()

    def _conn(self, conn):
        with conn, contextlib.suppress(ConnectionError, OSError, ValueError):
            f = conn.makefile("rb")
            while self._one(conn, f):
                pass

    def _one(self, conn, f):
        if not f.readline():
            return False
        headers = {}
        while True:
            h = f.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0"))
        if n:
            f.read(n)
        status, body, extra = self.script[min(self.hits, len(self.script) - 1)]
        self.hits += 1
        head = (f"HTTP/1.1 {status} X\r\nContent-Type: application/msgpack\r\n"
                f"Content-Length: {len(body)}\r\nConnection: keep-alive\r\n")
        for k, v in extra.items():
            head += f"{k}: {v}\r\n"
        conn.sendall(head.encode("latin-1") + b"\r\n" + body)
        return True

    def close(self):
        self._srv.close()


def _ok(request_id, n=2):
    return protocol.PredictResponse.from_arrays(
        request_id, np.zeros(n, np.float32), np.ones(n, np.float32),
        server_version=0, timing_ms=(0.1, 0.2, 0.3),
    ).encode()


def _err(code, retry_ms=None):
    return protocol.ErrorFrame("", code, f"scripted {code}", retry_after_ms=retry_ms).encode()


PTS = np.zeros((2, 2), np.float32)
FAST = RetryPolicy(max_attempts=4, base_backoff_ms=1.0, jitter=0.0)


@contextlib.contextmanager
def scripted(script):
    stub = ScriptedHTTP(script)
    try:
        yield stub
    finally:
        stub.close()


def test_sync_client_retries_shed_then_succeeds():
    script = [(429, _err("shed", 5.0), {}), (429, _err("shed", 5.0), {}), (200, _ok("r1"), {})]
    with scripted(script) as stub, NetClient("127.0.0.1", stub.port, retry=FAST, seed=0) as c:
        resp = c.predict(PTS, request_id="r1")
    assert isinstance(resp, protocol.PredictResponse) and stub.hits == 3


def test_sync_client_exhausts_attempts_and_never_retries_413():
    with scripted([(429, _err("shed", 1.0), {})]) as stub, NetClient(
        "127.0.0.1", stub.port, retry=RetryPolicy(max_attempts=2, base_backoff_ms=1.0, jitter=0.0)
    ) as c:
        with pytest.raises(RetriesExhausted) as exc:
            c.predict(PTS)
    assert exc.value.status == 429 and exc.value.frame.code == "shed" and stub.hits == 2
    with scripted([(413, _err("oversized"), {})]) as stub, NetClient(
        "127.0.0.1", stub.port, retry=FAST
    ) as c:
        with pytest.raises(ServerError) as exc:
            c.predict(PTS)
    assert not isinstance(exc.value, RetriesExhausted) and stub.hits == 1


def test_sync_client_honors_the_hint_and_the_deadline():
    script = [(429, _err("shed", 80.0), {}), (200, _ok("r1"), {})]
    with scripted(script) as stub, NetClient("127.0.0.1", stub.port, retry=FAST) as c:
        t0 = time.monotonic()
        c.predict(PTS, request_id="r1")
        assert time.monotonic() - t0 >= 0.080 and stub.hits == 2
    with scripted([(429, _err("shed", 500.0), {})]) as stub, NetClient(
        "127.0.0.1", stub.port, retry=FAST
    ) as c:
        with pytest.raises(DeadlineExceeded, match="cross the deadline"):
            c.predict(PTS, deadline_s=0.05)
    assert stub.hits == 1


def test_200_with_a_wrong_frame_or_a_foreign_id_is_a_protocol_error():
    with scripted([(200, _err("internal"), {})]) as stub, NetClient(
        "127.0.0.1", stub.port, retry=FAST
    ) as c:
        with pytest.raises(protocol.ProtocolError, match="ErrorFrame"):
            c.predict(PTS)
    with scripted([(200, _ok("someone-else"), {})]) as stub, NetClient(
        "127.0.0.1", stub.port, retry=FAST
    ) as c:
        with pytest.raises(protocol.ProtocolError, match="someone-else"):
            c.predict(PTS, request_id="mine")


def test_async_client_retries_reuses_the_connection_and_keeps_deadlines():
    script = [(429, _err("shed", 2.0), {}), (200, _ok("r1"), {}), (200, _ok("r2"), {})]

    async def main(port):
        async with AsyncNetClient("127.0.0.1", port, retry=FAST, seed=0) as c:
            r1 = await c.predict(PTS, request_id="r1")
            writer = c._writer
            r2 = await c.predict(PTS, request_id="r2")
            assert c._writer is writer
        return r1, r2

    with scripted(script) as stub:
        r1, r2 = asyncio.run(main(stub.port))
    assert (r1.request_id, r2.request_id, stub.hits) == ("r1", "r2", 3)

    async def late(port):
        async with AsyncNetClient("127.0.0.1", port, retry=FAST) as c:
            with pytest.raises(DeadlineExceeded):
                await c.predict(PTS, deadline_s=0.05)

    with scripted([(429, _err("shed", 500.0), {})]) as stub:
        asyncio.run(late(stub.port))


def test_retry_policy_validates_and_schedules():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=1.5)
    with pytest.raises(ValueError, match="max_backoff_ms"):
        RetryPolicy(base_backoff_ms=100.0, max_backoff_ms=10.0)
    p = RetryPolicy(base_backoff_ms=10.0, max_backoff_ms=40.0, jitter=0.0)
    rng = random.Random(0)
    assert p.delay_s(0, None, rng) == 0.010
    assert p.delay_s(2, None, rng) == 0.040
    assert p.delay_s(0, 200.0, rng) == 0.200


# ---------------------------------------------------------------------------
# end to end over the port's NetServer (sharded CPU lane, loop in a thread)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted():
    torch.set_num_threads(1)
    ds = e3sm_like_field(n=800, seed=0)
    return api.fit(api.FitConfig(grid=3, m=4, train_iters=40, seed=0), ds, device="cpu")


def _queries(fitted, n, seed):
    g = fitted.grid
    return np.random.default_rng(seed).uniform(
        [g.x_edges[0], g.y_edges[0]], [g.x_edges[-1], g.y_edges[-1]], (n, 2)
    ).astype(np.float32)


@pytest.fixture(scope="module")
def server(fitted):
    srv = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined"))
    srv.submit(_queries(fitted, 2048, 99))  # q_max past any request (see test_torch_frontdoor)
    return srv


@contextlib.contextmanager
def running(server, net=None, frontdoor=None, server_cls=None):
    """A NetServer (the port's unless ``server_cls``) on its own loop
    thread, so the blocking NetClient can be driven from the test thread."""
    if server_cls is None:
        from repro_torch.net.server import NetServer as server_cls
    if net is None:
        net = api.NetConfig(port=0)
    box = {}
    started = threading.Event()

    def run():
        async def main():
            box["loop"] = asyncio.get_running_loop()
            box["stop"] = asyncio.Event()
            async with server_cls(server, net, frontdoor) as ns:
                box["ns"] = ns
                started.set()
                await box["stop"].wait()

        asyncio.run(main())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(60), "NetServer failed to start"
    try:
        yield box["ns"]
    finally:
        box["loop"].call_soon_threadsafe(box["stop"].set)
        t.join(30)


def test_predict_over_the_wire_equals_submit_bitwise(server, fitted):
    pts = _queries(fitted, 16, 5)
    with running(server) as ns, NetClient("127.0.0.1", ns.port) as c:
        resp = c.predict(pts, deadline_s=30.0)
        conn = c._conn
        again = c.predict(pts, deadline_s=30.0)
        assert c._conn is conn  # keepalive held across requests
    mean, var = server.submit(pts)
    assert np.array_equal(resp.mean(), mean) and np.array_equal(resp.var(), var)
    assert np.array_equal(again.mean(), mean)
    assert resp.server_version == 0
    t = resp.timing()
    assert t["total_ms"] >= t["engine_ms"] >= 0 and t["decode_ms"] >= 0


def test_async_clients_concurrently_equal_submit_bitwise(server, fitted):
    rng = np.random.default_rng(6)
    reqs = [_queries(fitted, int(rng.integers(1, 65)), 100 + i) for i in range(12)]

    async def main(port):
        async def one(i):
            async with AsyncNetClient("127.0.0.1", port) as c:
                return await c.predict(reqs[i], request_id=f"g{i}")

        got = await asyncio.gather(*(one(i) for i in range(len(reqs))))
        async with AsyncNetClient("127.0.0.1", port) as c:
            status, health = await c.healthz()
        return got, status, health

    with running(server) as ns:
        got, status, health = asyncio.run(main(ns.port))
    for resp, q in zip(got, reqs, strict=True):
        mean, var = server.submit(q)
        assert np.array_equal(resp.mean(), mean) and np.array_equal(resp.var(), var)
    assert status == 200 and health["status"] == "ok"
    assert health["protocol_version"] == protocol.PROTOCOL_VERSION


def test_healthz_slo_and_transport_counters(server, fitted):
    with running(server) as ns, NetClient("127.0.0.1", ns.port) as c:
        status, health = c.healthz()
        assert status == 200 and health["status"] == "ok"
        c.predict(_queries(fitted, 1, 7))
        slo = c.slo()
    assert slo["requests"]["completed"] == 1
    assert slo["http"]["requests"] >= 3
    assert slo["http"]["errors"] == dict.fromkeys(protocol.ERROR_CODES, 0)
    assert slo["http"]["net_config"]["port"] == 0
    assert slo["lifecycle"]["active_version"] == 0


def _raw(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/msgpack"} if body else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_status_mapping_of_bad_requests(server):
    with running(server) as ns:
        status, body = _raw(ns.port, "POST", "/predict", b"\x00not msgpack")
        assert status == 400
        frame = protocol.decode_frame(body)
        assert frame.code == "bad-request" and frame.retry_after_ms is None
        status, body = _raw(ns.port, "POST", "/predict", _err("internal"))
        assert status == 400 and protocol.decode_frame(body).code == "bad-request"
        status, body = _raw(ns.port, "GET", "/nope")
        assert status == 404 and "error" in json.loads(body)
        status, body = _raw(ns.port, "GET", "/predict")
        assert status == 405 and "error" in json.loads(body)


def test_oversized_rows_and_bodies_map_to_413(server):
    fd_cfg = api.FrontDoorConfig(max_request_rows=8)
    with running(server, frontdoor=fd_cfg) as ns, NetClient("127.0.0.1", ns.port,
                                                            retry=FAST) as c:
        with pytest.raises(ServerError) as exc:
            c.predict(np.zeros((9, 2), np.float32))
        slo = c.slo()
    assert exc.value.status == 413 and exc.value.frame.code == "oversized"
    assert not isinstance(exc.value, RetriesExhausted)
    assert slo["http"]["errors"]["oversized"] == 1
    net = api.NetConfig(port=0, max_body_bytes=1024)
    with running(server, net=net) as ns, NetClient("127.0.0.1", ns.port, retry=FAST) as c:
        with pytest.raises(ServerError) as exc:
            c.predict(np.zeros((200, 2), np.float32))  # 1,600 raw bytes > 1,024
    assert exc.value.status == 413 and "max_body_bytes" in exc.value.frame.message


def test_shed_maps_to_429_with_retry_after(server):
    from repro_torch.net.server import SHED_RETRY_MS

    with running(server) as ns:
        async def reject(pts):
            raise api.RequestRejected("admission queue full")

        ns._fd.submit = reject
        with NetClient("127.0.0.1", ns.port,
                       retry=RetryPolicy(max_attempts=2, base_backoff_ms=1.0, jitter=0.0)) as c:
            with pytest.raises(RetriesExhausted) as exc:
                c.predict(np.zeros((1, 2), np.float32))
            slo = c.slo()
    assert exc.value.status == 429 and exc.value.frame.code == "shed"
    assert exc.value.frame.retry_after_ms == SHED_RETRY_MS
    assert slo["http"]["errors"]["shed"] == 2


def test_broken_engine_maps_to_503_and_healthz_degrades(server):
    with running(server) as ns:
        ns._fd._broken = RuntimeError("engine died in a test")
        with NetClient("127.0.0.1", ns.port,
                       retry=RetryPolicy(max_attempts=1, base_backoff_ms=1.0, jitter=0.0)) as c:
            status, health = c.healthz()
            assert status == 503 and health["status"] == "broken"
            with pytest.raises(RetriesExhausted) as exc:
                c.predict(np.zeros((1, 2), np.float32))
    assert exc.value.status == 503 and exc.value.frame.code == "engine-broken"
    assert exc.value.frame.retry_after_ms is not None


def test_swap_under_wire_load_zero_failures(fitted):
    ds = e3sm_like_field(n=800, seed=1)
    new = api.refit(fitted, ds, api.RefitConfig(train_iters=10))
    swap_server = api.Server(fitted, api.ServeConfig(mode="sharded"))
    pts = _queries(fitted, 4, 8)
    n_req = 24

    async def drive(port):
        loop = asyncio.get_running_loop()
        state = {"done": 0}

        async def stream(c):
            versions = []
            for i in range(n_req):
                resp = await c.predict(pts, request_id=f"s{i}")
                state["done"] += 1
                versions.append(resp.server_version)
            return versions

        async def swapper():
            while state["done"] < 5:
                await asyncio.sleep(0.001)
            await loop.run_in_executor(None, lambda: swap_server.swap(new, version=1))

        async with AsyncNetClient("127.0.0.1", port) as c:
            _, versions = await asyncio.gather(swapper(), stream(c))
        return versions

    with running(swap_server) as ns:
        versions = asyncio.run(drive(ns.port))
    assert len(versions) == n_req and set(versions) == {0, 1}
    assert versions == sorted(versions)
    lc = swap_server.lifecycle()
    assert lc["swaps"] == 1 and lc["active_version"] == 1


# ---------------------------------------------------------------------------
# across packages over real sockets
# ---------------------------------------------------------------------------


def test_jax_client_against_the_port_server_bitwise(server, fitted):
    from repro.net.client import AsyncNetClient as JAsyncNetClient
    from repro.net.client import NetClient as JNetClient

    reqs = [_queries(fitted, n, 200 + n) for n in (1, 7, 33, 64)]
    with running(server) as ns:
        with JNetClient("127.0.0.1", ns.port) as c:
            got = [c.predict(q) for q in reqs]

        async def one(q):
            async with JAsyncNetClient("127.0.0.1", ns.port) as c:
                return await c.predict(q)

        async def many():
            return await asyncio.gather(*(one(q) for q in reqs))

        got_async = asyncio.run(many())
    for q, resp, aresp in zip(reqs, got, got_async, strict=True):
        assert isinstance(resp, jprotocol.PredictResponse)
        mean, var = server.submit(q)
        for r in (resp, aresp):
            assert np.array_equal(r.mean(), mean) and np.array_equal(r.var(), var)


def test_port_client_against_the_jax_server_bitwise():
    from repro import api as japi
    from repro.data.spatial import e3sm_like_field as je3sm
    from repro.net.server import NetServer as JNetServer

    jfit = japi.fit(japi.FitConfig(grid=2, m=4, train_iters=30, seed=0), je3sm(n=500, seed=0))
    jserver = japi.Server(jfit)
    g = jfit.grid
    reqs = [np.random.default_rng(n).uniform([g.x_edges[0], g.y_edges[0]],
                                             [g.x_edges[-1], g.y_edges[-1]],
                                             (n, 2)).astype(np.float32) for n in (1, 9, 64)]
    with running(jserver, net=japi.NetConfig(port=0), server_cls=JNetServer) as ns:
        with NetClient("127.0.0.1", ns.port) as c:
            got = [c.predict(q) for q in reqs]  # one request a window: the solo shape
            status, health = c.healthz()
    assert status == 200 and health["protocol_version"] == protocol.PROTOCOL_VERSION
    for q, resp in zip(reqs, got, strict=True):
        assert isinstance(resp, protocol.PredictResponse)
        mean, var = jserver.submit(q)
        assert np.array_equal(resp.mean(), mean) and np.array_equal(resp.var(), var)


# ---------------------------------------------------------------------------
# the CLI: session files and python -m repro_torch.net.server
# ---------------------------------------------------------------------------


def test_http_flag_requires_a_net_section(tmp_path):
    from repro_torch.launch import serve_sharded as ss

    path = tmp_path / "session.json"
    path.write_text(json.dumps({"fit": {"grid": 2, "m": 4}}))
    args = types.SimpleNamespace(config=str(path), http=True)
    with pytest.raises(SystemExit, match="no 'net' section"):
        ss.session_configs(args, expect_mode="replicated")
    args.http = False
    assert ss.session_configs(args, expect_mode="replicated")[2] is None
    path.write_text(json.dumps({"fit": {"grid": 2, "m": 4}, "net": {"port": 0},
                                "serve": {"mode": "sharded"}}))
    args.http = True
    with pytest.raises(SystemExit, match="mode='sharded'"):
        ss.session_configs(args, expect_mode="replicated")
    fit_cfg, serve_cfg, net_cfg = ss.session_configs(args, expect_mode="sharded")
    assert net_cfg.port == 0 and serve_cfg.mode == "sharded" and fit_cfg.grid == 2
    assert api.load_session(str(path))[2] == net_cfg


def _cli(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH="src", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-u", "-m", "repro_torch.net.server", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_cli_serves_an_artifact_over_http_on_the_cpu_when_asked(fitted, tmp_path):
    art = fitted.save(str(tmp_path / "artifact"))
    session = tmp_path / "session.json"
    session.write_text(json.dumps({"serve": {"mode": "sharded"}, "net": {"port": 0}}))
    proc = _cli(["--gp-artifact", art, "--config", str(session), "--device", "cpu"])
    try:
        port = None
        for line in proc.stdout:
            if "http://127.0.0.1:" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, proc.stderr.read()[-3000:]
        q = _queries(fitted, 20, 9)
        with NetClient("127.0.0.1", port) as c:
            resp = c.predict(q)
            slo = c.slo()
        assert slo["serve_config"]["mode"] == "sharded"
        want = api.Server(fitted, api.ServeConfig(mode="sharded")).submit(q)
        np.testing.assert_allclose(resp.mean(), want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(resp.var(), want[1], rtol=1e-5, atol=1e-5)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def test_cli_refuses_to_serve_without_a_gpu_unless_told_cpu(fitted, tmp_path):
    art = fitted.save(str(tmp_path / "artifact"))
    proc = _cli(["--gp-artifact", art])
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in err and "http://" not in out


# ---------------------------------------------------------------------------
# on the card: the wire golden property through the fused lane
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wire_golden_on_the_fused_lane(cuda_device, fitted):
    server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined"),
                        device=cuda_device)
    assert server.backend == "fused"
    rng = np.random.default_rng(31)
    reqs = [_queries(fitted, int(rng.integers(1, 65)), 300 + i) for i in range(32)]

    async def main(port):
        async def one(i):
            async with AsyncNetClient("127.0.0.1", port) as c:
                return await c.predict(reqs[i], request_id=f"g{i}")

        return await asyncio.gather(*(one(i) for i in range(len(reqs))))

    with running(server) as ns:
        got = asyncio.run(main(ns.port))
    for resp, q in zip(got, reqs, strict=True):
        mean, var = server.submit(q)
        assert np.array_equal(resp.mean(), mean) and np.array_equal(resp.var(), var)
