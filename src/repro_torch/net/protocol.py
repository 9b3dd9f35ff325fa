"""The versioned msgpack wire protocol of the HTTP front door (PyTorch
port of ``repro.net.protocol``, byte-compatible with it).

One frame = one msgpack map. Every frame carries ``v`` (the protocol
version — a mismatch is a hard decode error) and ``kind``; the remaining
keys are an EXACT set per kind. Three kinds:

  ``predict_request``   request_id + n + points ((n, 2) float32 as raw
                        little-endian bytes — 8 bytes per query point)
  ``predict_response``  request_id + n + mean/var (raw float32 bytes)
                        + server_version (the model version that
                        answered, ``Server.lifecycle``) + a server-side
                        timing breakdown (decode/engine/total ms)
  ``error``             request_id + a TYPED code — "shed", "oversized",
                        "engine-broken", "bad-request", "internal" —
                        + message + optional retry_after_ms

Arrays cross the wire as raw ``<f4`` bytes, so the golden property
extends BITWISE over the wire by construction. The frames are encoded
and decoded by the port's stdlib codec (``repro_torch.codec``), which
writes the bytes ``msgpack.packb(frame, use_bin_type=True)`` writes: a
client or server of either package talks to the other's.
:func:`decode_frame` raises :class:`ProtocolError` — and only
``ProtocolError`` — on anything malformed: truncated bytes, trailing
bytes, an unknown type code, a non-str map key, wrong version, unknown
kind, missing/unknown/ill-typed keys, or byte lengths that disagree with
``n``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.codec import CodecError, packb, unpackb

PROTOCOL_VERSION = 1

ERROR_CODES = ("shed", "oversized", "engine-broken", "bad-request", "internal")

# HTTP status each typed error code maps to (server + client share this
# table; docs/net.md renders it)
STATUS_FOR_CODE = {
    "shed": 429,
    "oversized": 413,
    "engine-broken": 503,
    "bad-request": 400,
    "internal": 500,
}

_TIMING_KEYS = ("decode_ms", "engine_ms", "total_ms")


class ProtocolError(ValueError):
    """A frame that cannot be decoded: truncated/trailing/garbage bytes,
    a protocol version mismatch, an unknown kind, or a key set / type /
    byte-length violation. The one exception the wire layer raises for
    malformed input — msgpack internals never leak to callers."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ProtocolError(msg)


def _f32_bytes(arr, name: str, shape_tail: tuple[int, ...]) -> bytes:
    """Validate + serialize one array field as raw little-endian float32
    bytes (C order). The exactness of the over-the-wire golden property
    lives here: bytes in == bytes out, no re-rounding."""
    a = np.asarray(arr)
    _check(
        a.shape[1:] == shape_tail,
        f"{name} must have trailing shape {shape_tail}, got {a.shape}",
    )
    return np.ascontiguousarray(a, dtype="<f4").tobytes()


def _f32_array(buf: bytes, name: str, shape: tuple[int, ...]) -> np.ndarray:
    count = math.prod(shape)
    _check(
        isinstance(buf, bytes) and len(buf) == 4 * count,
        f"{name} must be {4 * count} raw float32 bytes for shape {shape}, "
        f"got {len(buf) if isinstance(buf, bytes) else type(buf).__name__}",
    )
    return np.frombuffer(buf, dtype="<f4").astype(np.float32).reshape(shape)


def _check_id(request_id) -> None:
    _check(
        isinstance(request_id, str) and 0 < len(request_id) <= 128,
        f"request_id must be a non-empty str of <= 128 chars, got {request_id!r}",
    )


@dataclasses.dataclass(frozen=True)
class PredictRequest:
    """One ``POST /predict`` body: a request id and (n, 2) query points."""

    request_id: str
    n: int
    points_f32: bytes  # (n, 2) float32, raw little-endian C-order bytes

    def __post_init__(self) -> None:
        _check_id(self.request_id)
        _check(
            isinstance(self.n, int) and self.n >= 1,
            f"n must be an int >= 1, got {self.n!r}",
        )
        _check(
            isinstance(self.points_f32, bytes) and len(self.points_f32) == 8 * self.n,
            f"points_f32 must be {8 * self.n} bytes for n={self.n} "
            f"(8 per (x, y) float32 point), got "
            f"{len(self.points_f32) if isinstance(self.points_f32, bytes) else type(self.points_f32).__name__}",
        )

    @classmethod
    def from_points(cls, request_id: str, points) -> PredictRequest:
        pts = np.asarray(points, np.float32)
        _check(
            pts.ndim == 2 and pts.shape[1] == 2 and pts.shape[0] >= 1,
            f"points must be (n >= 1, 2), got shape {pts.shape}",
        )
        return cls(request_id, int(pts.shape[0]), _f32_bytes(pts, "points", (2,)))

    def points(self) -> np.ndarray:
        return _f32_array(self.points_f32, "points_f32", (self.n, 2))

    def encode(self) -> bytes:
        return packb(
            {
                "v": PROTOCOL_VERSION,
                "kind": "predict_request",
                "request_id": self.request_id,
                "n": self.n,
                "points_f32": self.points_f32,
            }
        )


@dataclasses.dataclass(frozen=True)
class PredictResponse:
    """The success frame: per-point mean/var, the model version that
    served it, and the server-side timing breakdown in milliseconds
    (``decode_ms`` body parse, ``engine_ms`` awaiting
    ``FrontDoor.submit`` — queueing + batching + device, ``total_ms``
    request receipt to response encode)."""

    request_id: str
    n: int
    mean_f32: bytes  # (n,) float32 raw bytes
    var_f32: bytes  # (n,) float32 raw bytes
    server_version: int
    timing_ms: tuple[float, float, float]  # (decode_ms, engine_ms, total_ms)

    def __post_init__(self) -> None:
        _check_id(self.request_id)
        _check(
            isinstance(self.n, int) and self.n >= 1,
            f"n must be an int >= 1, got {self.n!r}",
        )
        for name in ("mean_f32", "var_f32"):
            buf = getattr(self, name)
            _check(
                isinstance(buf, bytes) and len(buf) == 4 * self.n,
                f"{name} must be {4 * self.n} bytes for n={self.n}, got "
                f"{len(buf) if isinstance(buf, bytes) else type(buf).__name__}",
            )
        _check(
            isinstance(self.server_version, int) and self.server_version >= 0,
            f"server_version must be an int >= 0, got {self.server_version!r}",
        )
        t = self.timing_ms
        _check(
            isinstance(t, tuple)
            and len(t) == len(_TIMING_KEYS)
            and all(isinstance(x, float) and math.isfinite(x) and x >= 0 for x in t),
            f"timing_ms must be {len(_TIMING_KEYS)} finite non-negative floats "
            f"{_TIMING_KEYS}, got {t!r}",
        )

    @classmethod
    def from_arrays(
        cls,
        request_id: str,
        mean,
        var,
        *,
        server_version: int,
        timing_ms: tuple[float, float, float],
    ) -> PredictResponse:
        m = np.asarray(mean, np.float32).reshape(-1)
        v = np.asarray(var, np.float32).reshape(-1)
        _check(
            m.shape == v.shape and m.shape[0] >= 1,
            f"mean/var must be equal-length (n >= 1,) arrays, got {m.shape} / {v.shape}",
        )
        return cls(
            request_id,
            int(m.shape[0]),
            _f32_bytes(m, "mean", ()),
            _f32_bytes(v, "var", ()),
            int(server_version),
            tuple(float(x) for x in timing_ms),
        )

    def mean(self) -> np.ndarray:
        return _f32_array(self.mean_f32, "mean_f32", (self.n,))

    def var(self) -> np.ndarray:
        return _f32_array(self.var_f32, "var_f32", (self.n,))

    def timing(self) -> dict:
        return dict(zip(_TIMING_KEYS, self.timing_ms, strict=True))

    def encode(self) -> bytes:
        return packb(
            {
                "v": PROTOCOL_VERSION,
                "kind": "predict_response",
                "request_id": self.request_id,
                "n": self.n,
                "mean_f32": self.mean_f32,
                "var_f32": self.var_f32,
                "server_version": self.server_version,
                "timing_ms": list(self.timing_ms),
            }
        )


@dataclasses.dataclass(frozen=True)
class ErrorFrame:
    """The typed failure frame. ``code`` is the machine-readable contract
    (one of :data:`ERROR_CODES`, each pinned to an HTTP status by
    :data:`STATUS_FOR_CODE`); ``message`` is for humans;
    ``retry_after_ms`` is set when retrying makes sense (shed,
    engine-broken) and None when it never will (oversized,
    bad-request)."""

    request_id: str  # "" when the failure preceded parsing an id
    code: str
    message: str
    retry_after_ms: float | None = None

    def __post_init__(self) -> None:
        _check(
            isinstance(self.request_id, str) and len(self.request_id) <= 128,
            f"request_id must be a str of <= 128 chars, got {self.request_id!r}",
        )
        _check(
            self.code in ERROR_CODES,
            f"code must be one of {ERROR_CODES}, got {self.code!r}",
        )
        _check(
            isinstance(self.message, str) and 0 < len(self.message) <= 2048,
            "message must be a non-empty str of <= 2048 chars",
        )
        if self.retry_after_ms is not None:
            _check(
                isinstance(self.retry_after_ms, float)
                and math.isfinite(self.retry_after_ms)
                and self.retry_after_ms >= 0,
                f"retry_after_ms must be a finite float >= 0 or None, "
                f"got {self.retry_after_ms!r}",
            )

    @property
    def status(self) -> int:
        return STATUS_FOR_CODE[self.code]

    def encode(self) -> bytes:
        return packb(
            {
                "v": PROTOCOL_VERSION,
                "kind": "error",
                "request_id": self.request_id,
                "code": self.code,
                "message": self.message,
                "retry_after_ms": self.retry_after_ms,
            }
        )


_FRAME_FIELDS = {
    "predict_request": ("request_id", "n", "points_f32"),
    "predict_response": (
        "request_id",
        "n",
        "mean_f32",
        "var_f32",
        "server_version",
        "timing_ms",
    ),
    "error": ("request_id", "code", "message", "retry_after_ms"),
}


def decode_frame(buf: bytes) -> PredictRequest | PredictResponse | ErrorFrame:
    """Strictly decode one wire frame, or raise :class:`ProtocolError`.

    Strict means: the buffer must be EXACTLY one msgpack map (truncated
    input and trailing bytes both fail), ``v`` must equal
    :data:`PROTOCOL_VERSION`, ``kind`` must be known, and the remaining
    keys must be exactly the kind's field set with every value passing
    the same ``__post_init__`` validation a locally-constructed frame
    gets. A frame that decodes is as trustworthy as one never serialized.
    """
    _check(isinstance(buf, (bytes, bytearray)), f"frame must be bytes, got {type(buf).__name__}")
    try:
        obj = unpackb(bytes(buf))
    except CodecError as err:  # truncated, trailing, garbage, non-str key
        raise ProtocolError(f"undecodable msgpack frame: {err}") from err
    _check(isinstance(obj, dict), f"frame must be a msgpack map, got {type(obj).__name__}")
    _check("v" in obj, "frame missing protocol version key 'v'")
    _check(
        obj["v"] == PROTOCOL_VERSION,
        f"protocol version mismatch: frame has v={obj['v']!r}, "
        f"this build speaks v={PROTOCOL_VERSION}",
    )
    kind = obj.get("kind")
    _check(
        kind in _FRAME_FIELDS,
        f"unknown frame kind {kind!r}; expected one of {sorted(_FRAME_FIELDS)}",
    )
    fields = _FRAME_FIELDS[kind]
    expected = {"v", "kind", *fields}
    _check(
        set(obj) == expected,
        f"{kind} frame key set mismatch: got {sorted(obj)}, expected {sorted(expected)}",
    )
    body = {k: obj[k] for k in fields}
    if kind == "predict_request":
        return PredictRequest(**body)
    if kind == "predict_response":
        t = body["timing_ms"]
        _check(
            isinstance(t, list) and all(isinstance(x, (int, float)) for x in t),
            f"timing_ms must be a list of numbers, got {t!r}",
        )
        body["timing_ms"] = tuple(float(x) for x in t)
        return PredictResponse(**body)
    if body["retry_after_ms"] is not None and isinstance(body["retry_after_ms"], int):
        body["retry_after_ms"] = float(body["retry_after_ms"])
    return ErrorFrame(**body)
