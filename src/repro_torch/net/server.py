"""The asyncio HTTP/1.1 endpoint over ``FrontDoor.submit`` (PyTorch port
of ``repro.net.server``).

A thin adapter: the coalesce/demux/backpressure engine
(``repro_torch.api.frontdoor``) is transport-agnostic — this module only
moves msgpack frames (``repro_torch.net.protocol``) across sockets and
maps the engine's typed outcomes onto HTTP statuses:

    POST /predict   one PredictRequest frame in, one PredictResponse
                    (or typed ErrorFrame) out:
                      RequestTooLarge -> 413 "oversized"
                      RequestRejected -> 429 "shed" + Retry-After
                      engine broken   -> 503 "engine-broken" + Retry-After
                      ProtocolError / bad points -> 400 "bad-request"
                      anything else   -> 500 "internal"
    GET  /healthz   JSON liveness: ok (200) or broken (503)
    GET  /slo       JSON ``FrontDoor.report()`` + the transport counters

Hand-rolled on ``asyncio.start_server`` (stdlib only). HTTP/1.1
persistent connections per ``NetConfig.keepalive``; per-read deadline
``read_timeout_s``; a body over ``max_body_bytes`` is refused with 413
before it is read. The wire is byte-compatible with the JAX package's:
either package's client talks to either package's server.

Entry point (on the card unless ``--device cpu``; the bind address
comes from the session file's ``net`` section or NetConfig's defaults):

  PYTHONPATH=src python -m repro_torch.net.server --gp-artifact DIR
  PYTHONPATH=src python -m repro_torch.net.server --gp-artifact DIR --config session.json
"""
from __future__ import annotations

import argparse
import asyncio
import json
import math
import time

from repro_torch import api
from repro_torch.net import protocol

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}
_MSGPACK = "application/msgpack"
_JSON = "application/json"
_MAX_HEADERS = 64

# frame-level retry hints (the Retry-After header is the integer-second
# ceiling of these; the client prefers the finer frame value)
SHED_RETRY_MS = 50.0
BROKEN_RETRY_MS = 1000.0


class _HttpError(Exception):
    """An HTTP-level failure decided before the engine was consulted.
    ``keep`` is False when the connection state is unrecoverable (e.g.
    an unread oversized body still sitting in the socket)."""

    def __init__(self, frame: protocol.ErrorFrame, *, keep: bool = True):
        super().__init__(frame.message)
        self.frame = frame
        self.keep = keep


class NetServer:
    """One listening socket in front of one ``api.Server``.

    Owns a private ``api.FrontDoor`` (created on :meth:`start`, closed
    on :meth:`close`) so every HTTP request rides the same continuous-
    batching engine the in-process benchmarks measure — the wire adds
    transport, never a second batching policy. All mutable state
    (transport counters) is event-loop-confined: connection handlers
    are loop tasks and the server never hands a method to a thread.

    Usage::

        async with NetServer(server, net_cfg) as ns:
            print(ns.port)          # bound port (net_cfg.port 0 -> OS pick)
            await ns.serve_forever()
    """

    def __init__(self, server, net=None, frontdoor=None):
        self.server = server
        self.net = api.NetConfig() if net is None else net
        self.frontdoor_config = frontdoor  # None -> FrontDoor's default
        self.port: int | None = None
        self._fd = None
        self._listener: asyncio.Server | None = None
        # transport counters, loop-confined
        self._http_requests = 0
        self._http_errors = dict.fromkeys(protocol.ERROR_CODES, 0)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._fd = api.FrontDoor(self.server, self.frontdoor_config)
        await self._fd.__aenter__()
        self._listener = await asyncio.start_server(
            self._handle_conn, self.net.host, self.net.port
        )
        self.port = self._listener.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._listener is not None:
            self._listener.close()
            await self._listener.wait_closed()
        if self._fd is not None:
            await self._fd.close()

    async def __aenter__(self) -> "NetServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def serve_forever(self) -> None:
        await self._listener.serve_forever()

    # -- connection handling ----------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        """One task per accepted connection: serve requests until the
        client goes away, keepalive is off, or a read deadline expires.
        Transport errors end the connection, never the server."""
        try:
            while await self._handle_one(reader, writer):
                pass
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            TimeoutError,
            asyncio.TimeoutError,
        ):
            pass  # half-closed or idle-timed-out connection: just drop it
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _handle_one(self, reader, writer) -> bool:
        """Serve one HTTP request; returns True to keep the connection."""
        line = await asyncio.wait_for(
            reader.readline(), self.net.read_timeout_s
        )
        if not line:
            return False  # clean EOF between requests
        # clock starts once the request line is in hand: on a keepalive
        # connection the readline above blocks across inter-request idle
        # time, which is the client's think time, not server work
        t0 = time.perf_counter()
        try:
            method, path, _version = line.decode("latin-1").split()
        except ValueError:
            body = json.dumps({"error": "malformed request line"}).encode()
            await self._send(writer, 400, body, _JSON, False)
            return False
        headers = await self._read_headers(reader)
        if headers is None:
            body = json.dumps({"error": "malformed headers"}).encode()
            await self._send(writer, 400, body, _JSON, False)
            return False
        keep = self.net.keepalive and headers.get("connection", "") != "close"
        self._http_requests += 1

        if path == "/healthz" and method == "GET":
            return await self._healthz(writer, keep)
        if path == "/slo" and method == "GET":
            body = json.dumps(self.slo(), sort_keys=True).encode()
            return await self._send(writer, 200, body, _JSON, keep)
        if path != "/predict":
            body = json.dumps({"error": f"unknown path {path}"}).encode()
            return await self._send(writer, 404, body, _JSON, keep)
        if method != "POST":
            body = json.dumps({"error": "POST only"}).encode()
            return await self._send(writer, 405, body, _JSON, keep)

        try:
            body = await self._read_body(reader, headers)
            frame = await self._predict(body, t0)
            status = 200
        except _HttpError as err:
            frame, status, keep = err.frame, err.frame.status, keep and err.keep
            self._http_errors[err.frame.code] += 1
        retry = frame.retry_after_ms if isinstance(frame, protocol.ErrorFrame) else None
        return await self._send(
            writer, status, frame.encode(), _MSGPACK, keep, retry_after_ms=retry
        )

    async def _read_headers(self, reader) -> dict | None:
        headers: dict = {}
        for _ in range(_MAX_HEADERS):
            line = await asyncio.wait_for(
                reader.readline(), self.net.read_timeout_s
            )
            if line in (b"\r\n", b"\n"):
                return headers
            if not line.endswith(b"\n") or b":" not in line:
                return None
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        return None  # header section too long

    async def _read_body(self, reader, headers: dict) -> bytes:
        try:
            n = int(headers.get("content-length", ""))
        except ValueError:
            raise _HttpError(
                protocol.ErrorFrame(
                    "", "bad-request", "POST /predict needs a Content-Length body"
                ),
                keep=False,  # an un-lengthed body cannot be drained safely
            ) from None
        if n > self.net.max_body_bytes:
            # refused BEFORE reading: the cap is what protects the server
            # from buffering an arbitrarily large body
            raise _HttpError(
                protocol.ErrorFrame(
                    "",
                    "oversized",
                    f"body of {n} bytes exceeds NetConfig.max_body_bytes="
                    f"{self.net.max_body_bytes}",
                ),
                keep=False,  # the unread body still sits in the socket
            )
        return await asyncio.wait_for(
            reader.readexactly(n), self.net.read_timeout_s
        )

    async def _predict(self, body: bytes, t0: float) -> protocol.PredictResponse:
        """Decode -> ``FrontDoor.submit`` -> encode, translating every
        engine outcome into its typed error frame."""
        try:
            frame = protocol.decode_frame(body)
            if not isinstance(frame, protocol.PredictRequest):
                raise protocol.ProtocolError(
                    f"POST /predict takes a predict_request frame, got "
                    f"{type(frame).__name__}"
                )
            pts = frame.points()
        except protocol.ProtocolError as err:
            raise _HttpError(
                protocol.ErrorFrame("", "bad-request", str(err))
            ) from err
        t1 = time.perf_counter()
        try:
            mean, var = await self._fd.submit(pts)
        except Exception as err:
            raise self._engine_error(frame.request_id, err) from err
        t2 = time.perf_counter()
        return protocol.PredictResponse.from_arrays(
            frame.request_id,
            mean,
            var,
            server_version=int(self.server.lifecycle()["active_version"]),
            timing_ms=(
                (t1 - t0) * 1e3,
                (t2 - t1) * 1e3,
                (time.perf_counter() - t0) * 1e3,
            ),
        )

    def _engine_error(self, request_id: str, err: Exception) -> _HttpError:
        """The status-code contract: every ``FrontDoor.submit`` outcome
        maps onto exactly one typed error code."""
        if isinstance(err, api.RequestTooLarge):
            code, retry = "oversized", None
        elif isinstance(err, api.RequestRejected):
            code, retry = "shed", SHED_RETRY_MS
        elif isinstance(err, RuntimeError):
            # engine failed / front door closed: retriable server trouble
            code, retry = "engine-broken", BROKEN_RETRY_MS
        elif isinstance(err, ValueError):
            code, retry = "bad-request", None
        else:
            code, retry = "internal", None
        return _HttpError(
            protocol.ErrorFrame(request_id, code, str(err), retry_after_ms=retry)
        )

    async def _healthz(self, writer, keep: bool) -> bool:
        broken = self._fd.broken
        body = json.dumps(
            {
                "status": "broken" if broken else "ok",
                "active_version": self.server.lifecycle()["active_version"],
                "protocol_version": protocol.PROTOCOL_VERSION,
            },
            sort_keys=True,
        ).encode()
        return await self._send(writer, 503 if broken else 200, body, _JSON, keep)

    def slo(self) -> dict:
        """``FrontDoor.report()`` plus the transport's own section."""
        rec = self._fd.report()
        rec["http"] = {
            "requests": self._http_requests,
            "errors": dict(self._http_errors),
            "net_config": self.net.to_dict(),
        }
        return rec

    async def _send(
        self,
        writer,
        status: int,
        body: bytes,
        content_type: str,
        keep: bool,
        *,
        retry_after_ms: float | None = None,
    ) -> bool:
        head = (
            f"HTTP/1.1 {status} {_REASONS[status]}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep else 'close'}\r\n"
        )
        if retry_after_ms is not None:
            head += f"Retry-After: {max(1, math.ceil(retry_after_ms / 1e3))}\r\n"
        writer.write(head.encode("latin-1") + b"\r\n" + body)
        await writer.drain()
        return keep


# --------------------------------------------------------------------------
# CLI entry point
# --------------------------------------------------------------------------


def serve_http(args, *, expect_mode: str | None = None) -> None:
    """The ``--http`` back half of the serving CLI: resolve the session
    (fit/serve/net sections), fit or load the artifact on ``--device``
    (``"cuda"`` unless told otherwise), and run the HTTP endpoint until
    interrupted.

    ``expect_mode`` pins the serve mode the calling CLI promises; None
    (the ``python -m repro_torch.net.server`` entry) follows the session
    file's serve section, defaulting to replicated, as in the JAX
    package. One GPU serves every cell, so the sharded mode needs no
    device count set up first.
    """
    from repro_torch.launch import serve_sharded as ss

    if expect_mode is None:
        expect_mode = "replicated"
        if getattr(args, "config", None):
            _, s_cfg, _ = api.load_session(args.config)
            if s_cfg is not None:
                expect_mode = s_cfg.mode
    fit_cfg, serve_cfg, net_cfg = ss.session_configs(args, expect_mode=expect_mode)
    if net_cfg is None:
        net_cfg = api.NetConfig()
    ds, fitted = ss.load_or_train(args, fit_cfg=fit_cfg)
    del ds  # the endpoint serves live queries, not a synthetic stream
    if serve_cfg is None:
        serve_cfg = api.ServeConfig(
            mode=expect_mode,
            pipeline="pipelined" if expect_mode == "sharded" else "serial",
            router=getattr(args, "gp_router", "single") if expect_mode == "sharded" else "single",
            backend="auto",
        )
    server = api.Server(fitted, serve_cfg)
    try:
        asyncio.run(_run(server, net_cfg))
    except KeyboardInterrupt:
        print("\nshutting down")


async def _run(server, net_cfg) -> None:
    async with NetServer(server, net_cfg) as ns:
        print(
            f"serving {server.config.mode} PSVGP on "
            f"http://{ns.net.host}:{ns.port}  "
            "(POST /predict, GET /healthz, GET /slo; Ctrl-C to stop)"
        )
        await ns.serve_forever()


def main() -> None:
    from repro_torch.launch.serve_sharded import add_gp_args

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    add_gp_args(ap)
    args = ap.parse_args()
    args.http = True  # this module IS the http entry point
    serve_http(args)


if __name__ == "__main__":
    main()
