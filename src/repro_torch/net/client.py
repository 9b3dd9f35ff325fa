"""Sync + async clients for the HTTP front door (PyTorch port of
``repro.net.client``; stdlib and numpy only).

Small on purpose — the wire is msgpack frames (``repro_torch.net.protocol``),
so a client is: one reusable connection, a bounded retry loop, a
per-request deadline. Both clients implement the same contract:

  * connection reuse: one persistent HTTP/1.1 connection per client,
    transparently reopened when the server closes it (``NetConfig
    .keepalive=False`` servers cost a reconnect per request);
  * bounded retries with jitter on 429 (shed) and 503 (engine broken),
    honoring the server's Retry-After: the wait is
    max(server hint, exponential backoff) +/- jitter, and the hint is
    read from the typed error frame's ``retry_after_ms`` (finer than
    the integer-second header) when present. 4xx that will never
    succeed (413 oversized, 400 bad-request) are NOT retried;
  * a per-request ``deadline_s`` spanning all attempts: when the next
    wait (or the next read) would cross it, the client raises
    :class:`DeadlineExceeded` rather than sleeping past it.

Failures are typed: :class:`ServerError` carries the decoded
:class:`~repro_torch.net.protocol.ErrorFrame` (so callers branch on
``err.frame.code``, not on message strings), :class:`DeadlineExceeded`
and :class:`RetriesExhausted` say which budget ran out.

    with NetClient("127.0.0.1", port) as c:
        resp = c.predict(points, deadline_s=2.0)
        mean, var = resp.mean(), resp.var()

    async with AsyncNetClient("127.0.0.1", port) as c:
        resp = await c.predict(points)
"""
from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import random
import socket
import time

import numpy as np

from repro_torch.net import protocol


class NetClientError(Exception):
    """Base of every failure this module raises."""


class ServerError(NetClientError):
    """The server answered with a typed error frame that is not (or no
    longer) retryable. ``frame.code`` is the machine-readable reason."""

    def __init__(self, status: int, frame: protocol.ErrorFrame):
        super().__init__(f"HTTP {status} [{frame.code}]: {frame.message}")
        self.status = status
        self.frame = frame


class RetriesExhausted(ServerError):
    """Every attempt drew a retryable answer (429/503) and the attempt
    budget ran out; carries the LAST error frame."""


class DeadlineExceeded(NetClientError):
    """The per-request deadline would be (or was) crossed — by a read
    still in flight, or by a backoff wait longer than the time left."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """The bounded-retry schedule both clients share.

    Attempt k (0-based) that draws a retryable status waits
    ``max(server hint, base_backoff_ms * 2**k)`` capped at
    ``max_backoff_ms``, then multiplied by a uniform jitter in
    [1 - jitter, 1 + jitter] — jitter is what keeps a synchronized
    client herd from re-arriving as one burst (the exact traffic shape
    admission control just shed).
    """

    max_attempts: int = 4
    base_backoff_ms: float = 25.0
    max_backoff_ms: float = 2000.0
    jitter: float = 0.5

    def __post_init__(self) -> None:
        if not int(self.max_attempts) >= 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not float(self.base_backoff_ms) >= 0:
            raise ValueError(f"base_backoff_ms must be >= 0, got {self.base_backoff_ms}")
        if not float(self.max_backoff_ms) >= float(self.base_backoff_ms):
            raise ValueError(
                f"max_backoff_ms must be >= base_backoff_ms, got {self.max_backoff_ms}"
            )
        if not 0.0 <= float(self.jitter) < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay_s(self, attempt: int, hint_ms: float | None, rng: random.Random) -> float:
        backoff = min(self.base_backoff_ms * 2.0**attempt, self.max_backoff_ms)
        wait = max(backoff, 0.0 if hint_ms is None else hint_ms)
        return wait * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)) / 1e3


_RETRYABLE = (429, 503)


def _retry_hint_ms(frame: protocol.ErrorFrame | None, headers: dict) -> float | None:
    """The server's wait hint: the frame's retry_after_ms when present,
    else the integer-second Retry-After header."""
    if frame is not None and frame.retry_after_ms is not None:
        return frame.retry_after_ms
    ra = headers.get("retry-after")
    if ra is not None:
        try:
            return float(ra) * 1e3
        except ValueError:
            return None
    return None


def _finish_predict(
    status: int, headers: dict, body: bytes, request_id: str
) -> tuple[protocol.PredictResponse, None] | tuple[None, tuple]:
    """Shared terminal logic of one predict attempt: returns
    (response, None) on success, (None, (hint_ms, last_err)) when the
    attempt is retryable, and raises ServerError when it never will be."""
    frame = protocol.decode_frame(body)
    if status == 200:
        if not isinstance(frame, protocol.PredictResponse):
            raise protocol.ProtocolError(
                f"200 response carried a {type(frame).__name__} frame"
            )
        if frame.request_id != request_id:
            raise protocol.ProtocolError(
                f"response for request {frame.request_id!r}, expected {request_id!r}"
            )
        return frame, None
    if not isinstance(frame, protocol.ErrorFrame):
        raise protocol.ProtocolError(
            f"HTTP {status} carried a {type(frame).__name__} frame, expected error"
        )
    if status in _RETRYABLE:
        return None, (_retry_hint_ms(frame, headers), ServerError(status, frame))
    raise ServerError(status, frame)


def _parse_status(line: bytes) -> int:
    parts = line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise protocol.ProtocolError(f"malformed HTTP status line {line!r}")
    return int(parts[1])


class NetClient:
    """Blocking client on ``http.client`` with one reusable connection."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        retry: RetryPolicy | None = None,
        timeout_s: float = 30.0,
        seed: int | None = None,
    ):
        self.host, self.port = host, int(port)
        self.retry = RetryPolicy() if retry is None else retry
        self.timeout_s = float(timeout_s)
        self._rng = random.Random(seed)
        self._conn: http.client.HTTPConnection | None = None
        self._count = 0

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "NetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(
        self, method: str, path: str, body: bytes | None, remaining: float
    ) -> tuple[int, dict, bytes]:
        """One HTTP round trip on the persistent connection, reopened on
        a server-side close. Raises DeadlineExceeded on timeout."""
        if remaining <= 0:
            raise DeadlineExceeded(f"deadline crossed before sending {path}")
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=min(self.timeout_s, remaining)
            )
        elif self._conn.sock is not None:
            self._conn.sock.settimeout(min(self.timeout_s, remaining))
        headers = {"Content-Type": "application/msgpack"} if body else {}
        try:
            self._conn.request(method, path, body=body, headers=headers)
            resp = self._conn.getresponse()
            data = resp.read()
        except (TimeoutError, socket.timeout) as err:
            self.close()
            raise DeadlineExceeded(f"{path} timed out after {remaining:.3f}s") from err
        except (ConnectionError, http.client.HTTPException, OSError):
            self.close()
            raise
        if resp.will_close:
            self.close()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data

    def predict(
        self,
        points,
        *,
        request_id: str | None = None,
        deadline_s: float | None = None,
    ) -> protocol.PredictResponse:
        """POST one predict request; retry 429/503 within the deadline."""
        if request_id is None:
            self._count += 1
            request_id = f"c{self._count}"
        body = protocol.PredictRequest.from_points(request_id, points).encode()
        t_end = time.monotonic() + (self.timeout_s if deadline_s is None else deadline_s)
        last: ServerError | None = None
        for attempt in range(self.retry.max_attempts):
            try:
                status, headers, data = self._request(
                    "POST", "/predict", body, t_end - time.monotonic()
                )
            except (ConnectionError, http.client.HTTPException, OSError):
                if attempt + 1 >= self.retry.max_attempts:
                    raise
                self._sleep(attempt, None, t_end)
                continue
            resp, retryable = _finish_predict(status, headers, data, request_id)
            if resp is not None:
                return resp
            hint, last = retryable
            if attempt + 1 < self.retry.max_attempts:
                self._sleep(attempt, hint, t_end)
        raise RetriesExhausted(last.status, last.frame)

    def _sleep(self, attempt: int, hint_ms: float | None, t_end: float) -> None:
        delay = self.retry.delay_s(attempt, hint_ms, self._rng)
        if time.monotonic() + delay > t_end:
            raise DeadlineExceeded(
                f"retry backoff of {delay * 1e3:.0f} ms would cross the deadline"
            )
        time.sleep(delay)

    def healthz(self) -> tuple[int, dict]:
        status, _, data = self._request("GET", "/healthz", None, self.timeout_s)
        return status, json.loads(data)

    def slo(self) -> dict:
        status, _, data = self._request("GET", "/slo", None, self.timeout_s)
        if status != 200:
            raise NetClientError(f"GET /slo answered HTTP {status}")
        return json.loads(data)


class AsyncNetClient:
    """asyncio client on a persistent stream pair — many of these, one per
    simulated user, make an open-loop load generator."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        retry: RetryPolicy | None = None,
        timeout_s: float = 30.0,
        seed: int | None = None,
    ):
        self.host, self.port = host, int(port)
        self.retry = RetryPolicy() if retry is None else retry
        self.timeout_s = float(timeout_s)
        self._rng = random.Random(seed)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._count = 0

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            self._reader = self._writer = None

    async def __aenter__(self) -> "AsyncNetClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def _roundtrip(
        self, method: str, path: str, body: bytes | None, remaining: float
    ) -> tuple[int, dict, bytes]:
        if remaining <= 0:
            raise DeadlineExceeded(f"deadline crossed before sending {path}")
        try:
            return await asyncio.wait_for(
                self._roundtrip_inner(method, path, body),
                min(self.timeout_s, remaining),
            )
        except (TimeoutError, asyncio.TimeoutError) as err:
            await self.close()
            raise DeadlineExceeded(f"{path} timed out after {remaining:.3f}s") from err
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            await self.close()
            raise

    async def _roundtrip_inner(
        self, method: str, path: str, body: bytes | None
    ) -> tuple[int, dict, bytes]:
        if self._writer is None:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )
        head = f"{method} {path} HTTP/1.1\r\nHost: {self.host}\r\n"
        if body is not None:
            head += f"Content-Type: application/msgpack\r\nContent-Length: {len(body)}\r\n"
        self._writer.write(head.encode("latin-1") + b"\r\n" + (body or b""))
        await self._writer.drain()
        status_line = await self._reader.readline()
        if not status_line:
            raise ConnectionResetError("server closed the connection")
        status = _parse_status(status_line)
        headers: dict = {}
        while True:
            line = await self._reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        data = await self._reader.readexactly(int(headers.get("content-length", "0")))
        if headers.get("connection", "") == "close":
            await self.close()
        return status, headers, data

    async def predict(
        self,
        points,
        *,
        request_id: str | None = None,
        deadline_s: float | None = None,
    ) -> protocol.PredictResponse:
        """Async twin of :meth:`NetClient.predict` — same retry/deadline
        contract, non-blocking waits."""
        if request_id is None:
            self._count += 1
            request_id = f"a{self._count}"
        body = protocol.PredictRequest.from_points(request_id, points).encode()
        loop = asyncio.get_running_loop()
        t_end = loop.time() + (self.timeout_s if deadline_s is None else deadline_s)
        last: ServerError | None = None
        for attempt in range(self.retry.max_attempts):
            try:
                status, headers, data = await self._roundtrip(
                    "POST", "/predict", body, t_end - loop.time()
                )
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                if attempt + 1 >= self.retry.max_attempts:
                    raise
                await self._wait(attempt, None, t_end)
                continue
            resp, retryable = _finish_predict(status, headers, data, request_id)
            if resp is not None:
                return resp
            hint, last = retryable
            if attempt + 1 < self.retry.max_attempts:
                await self._wait(attempt, hint, t_end)
        raise RetriesExhausted(last.status, last.frame)

    async def _wait(self, attempt: int, hint_ms: float | None, t_end: float) -> None:
        delay = self.retry.delay_s(attempt, hint_ms, self._rng)
        if asyncio.get_running_loop().time() + delay > t_end:
            raise DeadlineExceeded(
                f"retry backoff of {delay * 1e3:.0f} ms would cross the deadline"
            )
        await asyncio.sleep(delay)

    async def healthz(self) -> tuple[int, dict]:
        status, _, data = await self._roundtrip("GET", "/healthz", None, self.timeout_s)
        return status, json.loads(data)

    async def slo(self) -> dict:
        status, _, data = await self._roundtrip("GET", "/slo", None, self.timeout_s)
        if status != 200:
            raise NetClientError(f"GET /slo answered HTTP {status}")
        return json.loads(data)


def predict_points(resp: protocol.PredictResponse) -> tuple[np.ndarray, np.ndarray]:
    """(mean, var) numpy pair of a response — the shape ``FrontDoor
    .submit`` returns, for callers comparing the two paths bitwise."""
    return resp.mean(), resp.var()
