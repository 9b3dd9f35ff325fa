"""repro_torch.net — the HTTP front door over the wire (PyTorch port of
``repro.net``).

Three thin layers over the transport-agnostic ``api.FrontDoor`` engine:

  * :mod:`repro_torch.net.protocol` — the versioned msgpack wire frames
    (predict request / predict response / typed error), byte-compatible
    with the JAX package's and encoded by the port's stdlib codec;
  * :mod:`repro_torch.net.server` — an asyncio HTTP/1.1 endpoint
    (``POST /predict``, ``GET /healthz``, ``GET /slo``);
    ``python -m repro_torch.net.server --gp-artifact DIR`` serves it;
  * :mod:`repro_torch.net.client` — sync and async clients with
    connection reuse, bounded jittered retries and deadlines.

Only query points and mean/var cross the wire, as raw ``<f4`` bytes, so
an answer over HTTP equals the in-process answer bitwise.
"""
from repro_torch.net.protocol import (
    PROTOCOL_VERSION,
    ErrorFrame,
    PredictRequest,
    PredictResponse,
    ProtocolError,
    decode_frame,
)

__all__ = [
    "PROTOCOL_VERSION",
    "ErrorFrame",
    "PredictRequest",
    "PredictResponse",
    "ProtocolError",
    "decode_frame",
]
