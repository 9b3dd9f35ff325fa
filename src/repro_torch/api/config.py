"""Frozen session configs — copied from ``repro.api.config``.

:class:`FitConfig` is the training recipe of ``api.fit`` (and is read back
from an artifact's ``artifact.json``); :class:`RefitConfig` the recipe of
one in-situ ``api.refit`` step; :class:`ServeConfig` fully determines
how a loaded artifact answers queries (``api.Server``);
:class:`FrontDoorConfig` how the async front door batches and admits, and
:class:`NetConfig` how the HTTP front door binds (``load_session`` reads
all three sections of a session file). Each round-trips
through the same JSON as the JAX package's, lane names included, so one
session file configures both packages. Only
:meth:`ServeConfig.resolve_backend` differs: it decides by the torch
device the server runs on.
"""
from __future__ import annotations

import dataclasses
import json

import torch

_COMMS = ("gather", "ppermute")
_COVARIANCES = ("rbf", "matern32", "matern52")
_MODES = ("replicated", "sharded")
_PIPELINES = ("serial", "pipelined")
_ROUTERS = ("single", "two-level")
_BACKENDS = ("auto", "ref", "pallas", "fused")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _from_dict(cls, d: dict):
    """Shared strict constructor: unknown keys are config rot, not noise."""
    _check(isinstance(d, dict), f"{cls.__name__} expects a dict, got {type(d).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    _check(not unknown, f"unknown {cls.__name__} fields {sorted(unknown)}; have {sorted(known)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Everything ``api.fit`` needs besides the data itself.

    Fields:
      grid: partition grid side — the model has ``grid**2`` partitions,
        and sharded serving wants one device per partition.
      m: inducing points per partition (the paper's m).
      delta: eq. (9) neighbor-sampling weight (0 = ISVGP, 1 = full PSVGP).
        Blending needs delta > 0 to be an interpolation rather than an
        extrapolation (README; tests/test_blend.py) — hence the default.
      train_iters / batch_size / learning_rate / seed: the SGD budget.
      comm: "gather" (paper-faithful) | "ppermute" (TPU-native).
      covariance / whitened / jitter: the local-SVGP numerics
        (``repro.core.svgp.SVGPConfig``).
    """

    grid: int = 8
    m: int = 10
    delta: float = 0.25
    train_iters: int = 200
    batch_size: int = 32
    learning_rate: float = 0.05
    seed: int = 0
    comm: str = "gather"
    covariance: str = "rbf"
    whitened: bool = False
    jitter: float = 1e-5

    def __post_init__(self) -> None:
        _check(int(self.grid) >= 1, f"grid must be >= 1, got {self.grid}")
        _check(int(self.m) >= 1, f"m must be >= 1, got {self.m}")
        _check(0.0 <= float(self.delta) <= 1.0, f"delta must be in [0, 1], got {self.delta}")
        _check(int(self.train_iters) >= 0, f"train_iters must be >= 0, got {self.train_iters}")
        _check(int(self.batch_size) >= 1, f"batch_size must be >= 1, got {self.batch_size}")
        _check(float(self.learning_rate) > 0, f"learning_rate must be > 0, got {self.learning_rate}")
        _check(self.comm in _COMMS, f"comm must be one of {_COMMS}, got {self.comm!r}")
        _check(
            self.covariance in _COVARIANCES,
            f"covariance must be one of {_COVARIANCES}, got {self.covariance!r}",
        )
        _check(float(self.jitter) > 0, f"jitter must be > 0, got {self.jitter}")

    @property
    def num_partitions(self) -> int:
        return int(self.grid) ** 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FitConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "FitConfig":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How a trained artifact answers queries.

    Fields:
      mode: "replicated" (every query gathers its 4 corners' factors —
        ``blend.predict_blended``) | "sharded" (the halo program —
        ``launch.serve_sharded``; on one GPU every cell is local).
      pipeline: "serial" (route + evaluate + scatter per request) |
        "pipelined" (batch t+1 routed on the host while the device
        evaluates batch t; bitwise-identical results). Sharded only — the replicated
        path has no device stage to overlap with.
      router: "single" (every device block pads to the hottest cell's
        count) | "two-level" (hot-cell overflow spills onto corner-cell
        neighbors — ``routing.TwoLevelQMax``). Sharded only.
      backend: kernel lane for the cached-posterior evaluation (the JAX
        package's names, so one session JSON configures both packages) —
        "ref"    plain PyTorch (every covariance);
        "pallas" the single-block CUDA kernel that replaces the Pallas
                 ``posterior_predict_pallas``: one launch over every
                 cell's 9 * q_max rows on the halo path (RBF only);
        "fused"  the slots CUDA kernel that replaces the Pallas
                 ``posterior_predict_slots_pallas``: one launch over every
                 cell's 9-slot halo (RBF only; the production lane);
        "auto"   "fused" on a CUDA device, "ref" when the caller asked
                 for the CPU (see :meth:`resolve_backend`).
      headroom / pad_multiple: the streaming q_max policy's growth rule
        (``routing.StreamingQMax``).
      q_max: fixed per-partition block size instead of the streaming
        policy, for streams known up front. Sharded single-router only.
    """

    mode: str = "replicated"
    pipeline: str = "serial"
    router: str = "single"
    backend: str = "auto"
    headroom: float = 1.25
    pad_multiple: int = 8
    q_max: int | None = None

    def __post_init__(self) -> None:
        _check(self.mode in _MODES, f"mode must be one of {_MODES}, got {self.mode!r}")
        _check(
            self.pipeline in _PIPELINES,
            f"pipeline must be one of {_PIPELINES}, got {self.pipeline!r}",
        )
        _check(self.router in _ROUTERS, f"router must be one of {_ROUTERS}, got {self.router!r}")
        _check(self.backend in _BACKENDS, f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        _check(float(self.headroom) >= 1.0, f"headroom must be >= 1, got {self.headroom}")
        _check(int(self.pad_multiple) >= 1, f"pad_multiple must be >= 1, got {self.pad_multiple}")
        if self.mode == "replicated":
            _check(
                self.pipeline == "serial",
                "mode='replicated' serves synchronously — pipeline='pipelined' "
                "overlaps host routing with the device mesh, which only exists "
                "in mode='sharded'",
            )
            _check(
                self.router == "single",
                "router='two-level' balances per-DEVICE block padding — it "
                "only applies to mode='sharded'",
            )
            _check(
                self.backend in ("auto", "ref"),
                f"mode='replicated' evaluates through blend.predict_blended, "
                f"which has no {self.backend!r} lane — use backend='auto' or "
                "'ref', or serve sharded",
            )
        if self.q_max is not None:
            _check(int(self.q_max) >= 1, f"q_max must be >= 1, got {self.q_max}")
            _check(
                self.mode == "sharded" and self.router == "single",
                "a fixed q_max is the whole-stream-prepass lane of sharded "
                "single-router serving; streaming policies (and the two-level "
                "router's spill budget) own q_max otherwise",
            )

    def resolve_backend(self, device) -> str:
        """The concrete kernel lane this config serves with on ``device``
        ("ref" | "pallas" | "fused"). "auto" is "fused" on CUDA and "ref"
        on the CPU; replicated mode is always "ref" (its blend path has
        no kernel lane). On the CPU the kernel lanes run the kernels'
        plain PyTorch versions — a correctness lane, not a speed lane."""
        if self.mode == "replicated":
            return "ref"
        if self.backend == "auto":
            return "fused" if torch.device(device).type == "cuda" else "ref"
        return self.backend

    def make_policy(self):
        """The streaming q_max policy this config routes with, or None when
        ``q_max`` pins a fixed block size (exactly one of the two drives
        ``serve_sharded.make_request_stages``)."""
        from repro_torch.core import routing

        if self.q_max is not None:
            return None
        if self.router == "two-level":
            return routing.TwoLevelQMax(
                headroom=self.headroom, pad_multiple=self.pad_multiple
            )
        return routing.StreamingQMax(
            headroom=self.headroom, pad_multiple=self.pad_multiple
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "ServeConfig":
        return cls.from_dict(json.loads(s))


_INITS = ("warm", "scratch")


@dataclasses.dataclass(frozen=True)
class RefitConfig:
    """How ``api.refit`` updates a fitted surface for a new simulation step.

    The in-situ loop refits the SAME FitConfig recipe against each new time
    slice, with the previous step's parameters as the initializer and a
    much shorter SGD budget.

    Fields:
      train_iters: the refit SGD budget (iterations for THIS step).
      init: "warm" starts from the previous step's params (and Adam
        moments); "scratch" re-initializes from the FitConfig's seed
        exactly like ``api.fit`` — with ``train_iters`` equal to the
        FitConfig's full budget, the scratch path is bitwise-identical to
        ``fit()``.
      reset_optimizer: warm-start the params but zero the Adam moments.
        Artifacts loaded from disk carry no moments, so refitting a LOADED
        artifact always re-initializes the optimizer.
      learning_rate: override the FitConfig learning rate for this refit
        only (None keeps it).
    """

    train_iters: int = 50
    init: str = "warm"
    reset_optimizer: bool = False
    learning_rate: float | None = None

    def __post_init__(self) -> None:
        _check(int(self.train_iters) >= 0, f"train_iters must be >= 0, got {self.train_iters}")
        _check(self.init in _INITS, f"init must be one of {_INITS}, got {self.init!r}")
        if self.learning_rate is not None:
            _check(
                float(self.learning_rate) > 0,
                f"learning_rate must be > 0, got {self.learning_rate}",
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "RefitConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "RefitConfig":
        return cls.from_dict(json.loads(s))


_ADMISSIONS = ("delay", "shed")


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """How the async front door (``repro_torch.api.frontdoor``) coalesces many
    small independent requests into device batches.

    Fields:
      max_wait_ms: batching-window time trigger — once the first request
        of a window arrives, the batcher waits at most this long for more
        before dispatching (the latency a lightly-loaded request pays to
        buy coalescing under load).
      max_rows: batching-window size trigger — dispatch as soon as the
        coalesced window reaches this many query points, however young
        the window is (caps the device batch, bounding q_max growth).
      max_request_rows: largest single request admitted (points per
        request). The front door serves MANY SMALL queries; a bulk batch
        should go straight to ``Server.submit``.
      queue_depth: admission-queue bound, in requests. The queue is what
        absorbs bursts.
      admission: what happens to a request arriving at a full queue —
        "delay" applies backpressure (the await blocks until a slot
        frees: closed-loop clients slow down), "shed" rejects it
        immediately (``frontdoor.RequestRejected``: open-loop traffic is
        load-shed instead of building an unbounded backlog).
    """

    max_wait_ms: float = 2.0
    max_rows: int = 1024
    max_request_rows: int = 64
    queue_depth: int = 256
    admission: str = "delay"

    def __post_init__(self) -> None:
        _check(float(self.max_wait_ms) >= 0, f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        _check(int(self.max_rows) >= 1, f"max_rows must be >= 1, got {self.max_rows}")
        _check(
            1 <= int(self.max_request_rows) <= int(self.max_rows),
            f"max_request_rows must be in [1, max_rows={self.max_rows}], "
            f"got {self.max_request_rows}",
        )
        _check(int(self.queue_depth) >= 1, f"queue_depth must be >= 1, got {self.queue_depth}")
        _check(
            self.admission in _ADMISSIONS,
            f"admission must be one of {_ADMISSIONS}, got {self.admission!r}",
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FrontDoorConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "FrontDoorConfig":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """How the HTTP front door (``repro_torch.net.server``) binds and guards the
    socket. The transport knobs only — batching and admission stay in
    :class:`FrontDoorConfig`, the model in Fit/ServeConfig.

    Fields:
      host / port: the listen address. Port 0 asks the OS for a free
        port (the test and benchmark lane); the bound port is in
        ``NetServer.port``.
      max_body_bytes: largest accepted ``POST /predict`` body. A body
        over the cap is refused with 413 BEFORE it is read into memory —
        the transport-level twin of the front door's
        ``max_request_rows`` admission check.
      read_timeout_s: per-request read deadline — a client that stalls
        mid-body is disconnected rather than pinning a reader task.
      keepalive: serve multiple requests per connection (HTTP/1.1
        persistent connections). Off, every response carries
        ``Connection: close`` — the knob for measuring connection setup
        cost.
    """

    host: str = "127.0.0.1"
    port: int = 8777
    max_body_bytes: int = 1_048_576
    read_timeout_s: float = 30.0
    keepalive: bool = True

    def __post_init__(self) -> None:
        _check(
            isinstance(self.host, str) and len(self.host) > 0,
            f"host must be a non-empty str, got {self.host!r}",
        )
        _check(
            0 <= int(self.port) <= 65535,
            f"port must be in [0, 65535] (0 = OS-assigned), got {self.port}",
        )
        _check(
            int(self.max_body_bytes) >= 1024,
            f"max_body_bytes must be >= 1024, got {self.max_body_bytes}",
        )
        _check(
            float(self.read_timeout_s) > 0,
            f"read_timeout_s must be > 0, got {self.read_timeout_s}",
        )
        _check(
            isinstance(self.keepalive, bool),
            f"keepalive must be a bool, got {self.keepalive!r}",
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "NetConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "NetConfig":
        return cls.from_dict(json.loads(s))


def load_session(path: str):
    """Read a session file: ``{"fit": {...}, "serve": {...}, "net":
    {...}}``, every section optional, no other keys. Returns
    (fit, serve, net) with ``None`` for an absent section.

    This is the ``--config session.json`` lane of the serving CLIs — the
    same JSON a saved artifact manifest or a benchmark row carries, so a
    recorded session replays without reconstructing flag spellings.
    Stdlib-only, as in the JAX package, where the CLIs read it before
    the accelerator backend initializes.
    """
    with open(path, encoding="utf-8") as f:
        d = json.load(f)
    _check(isinstance(d, dict), f"session file {path} must hold a JSON object")
    unknown = set(d) - {"fit", "serve", "net"}
    _check(not unknown, f"unknown session sections {sorted(unknown)}; use 'fit'/'serve'/'net'")
    fit = FitConfig.from_dict(d["fit"]) if "fit" in d else None
    serve = ServeConfig.from_dict(d["serve"]) if "serve" in d else None
    net = NetConfig.from_dict(d["net"]) if "net" in d else None
    return fit, serve, net
