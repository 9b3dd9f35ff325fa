"""Frozen session configs — copied from ``repro.api.config``.

:class:`FitConfig` is the training recipe of ``api.fit`` (and is read back
from an artifact's ``artifact.json``); :class:`RefitConfig` the recipe of
one in-situ ``api.refit`` step; :class:`ServeConfig` fully determines
how a loaded artifact answers queries (``api.Server``). Both round-trip
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
