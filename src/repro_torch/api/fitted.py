"""``fit`` and ``FittedPSVGP`` — train once, persist a parsimonious
artifact, serve it (PyTorch).

Port of ``repro.api.fitted``. The artifact format is the JAX package's: a
directory with ``artifact.json`` (the FitConfig and the grid geometry,
plain JSON) and the ``checkpoint`` pytree of ``params/...`` and the cached
factors ``cache/{z,w,u,c,cov/...,log_beta}``. numpy reads it all, so a model
trained by either package serves in the other:

    fitted = api.fit(FitConfig(grid=20, m=5), (x, y))      # on "cuda"
    fitted.save("runs/e3sm_t42/")
    server = api.Server(api.FittedPSVGP.load("runs/e3sm_t42/"), ServeConfig(mode="sharded"))

A fitted model carries its training state (params, Adam moments, step
counter, the sampler's tables) beside the cache; a LOADED artifact carries
params only, as in the JAX package, and ``refit`` re-initializes its
optimizer. On a CUDA device every training step runs the ELBO's
projection as one launch of the hand-written kernel
(``_psvgp_config``: ``use_pallas`` for the RBF on CUDA).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.api.config import FitConfig, RefitConfig
from repro_torch.checkpoint import load_arrays, save_pytree
from repro_torch.checkpoint import store as artifact_store
from repro_torch.core import posterior, psvgp, svgp
from repro_torch.core.blend import predict_blended
from repro_torch.core.partition import PartitionGrid, make_grid, partition_data
from repro_torch.device import resolve_device
from repro_torch.gp.covariances import CovarianceParams, make_covariance
from repro_torch.optim import AdamState, adam_init

ARTIFACT_MANIFEST = "artifact.json"
ARTIFACT_FORMAT = 1
INPUT_DIM = 2  # spatial modeling: (lon, lat) / (x, y) coordinates

_PARAM_KEYS = (
    "params/m_star", "params/s_tril", "params/z",
    "params/cov/log_lengthscale", "params/cov/log_variance", "params/log_beta",
)
_CACHE_KEYS = (
    "cache/z", "cache/w", "cache/u", "cache/c",
    "cache/cov/log_lengthscale", "cache/cov/log_variance", "cache/log_beta",
)


def _psvgp_config(cfg: FitConfig, device: torch.device) -> psvgp.PSVGPConfig:
    """The one FitConfig -> PSVGPConfig mapping every entry point shares.
    The ELBO's projection runs in the CUDA kernel on a CUDA device for the
    RBF covariance (the rule by which ``ServeConfig(backend="auto")`` picks
    the kernel lane), its plain PyTorch form otherwise."""
    return psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(
            num_inducing=cfg.m,
            input_dim=INPUT_DIM,
            covariance=cfg.covariance,
            jitter=cfg.jitter,
            whitened=cfg.whitened,
            use_pallas=device.type == "cuda" and cfg.covariance == "rbf",
        ),
        delta=cfg.delta,
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        comm=cfg.comm,
        seed=cfg.seed,
    )


def _shapes(config: FitConfig) -> dict[str, tuple]:
    P, m, d = config.num_partitions, config.m, INPUT_DIM
    out = {}
    for root in ("params", "cache"):
        out[f"{root}/z"] = (P, m, d)
        out[f"{root}/cov/log_lengthscale"] = (P, d)
        out[f"{root}/cov/log_variance"] = (P,)
        out[f"{root}/log_beta"] = (P,)
    out.update({
        "params/m_star": (P, m), "params/s_tril": (P, m, m),
        "cache/w": (P, m, m), "cache/u": (P, m, m), "cache/c": (P, m),
    })
    return out


def _resolve_artifact_dir(path: str, step: int | None) -> str:
    if artifact_store.is_store(path):
        return artifact_store.step_dir(path, step)
    if step is not None:
        raise ValueError(
            f"{path!r} is a single format-1 artifact, not a format-2 store "
            "— it has no step index to select from"
        )
    return path


def _move(tree: Any, device: torch.device) -> Any:
    """Every tensor of a nest of NamedTuples moved to ``device``; other
    leaves (ints, configs, functions, None) kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_move(t, device) for t in tree))
    return tree


class FittedPSVGP:
    """A trained partitioned surface: config + grid + training state + cached
    factors, as tensors on one device.

    Attributes:
      config: the :class:`FitConfig` that produced (or describes) it.
      grid:   the ``PartitionGrid`` it was trained on.
      static / state: the ``core.psvgp`` bundle (``static.dist``/``perms``/
        ``p_dir`` are None and ``state.opt`` has no moments on a loaded
        artifact).
      cache:  the P-stacked ``PosteriorCache`` — the artifact's factors, or
        factorized once from the params on first use.
      train_seconds / refit_seconds: wall-clock of the training (to a
        device synchronize) that produced it; None on loaded artifacts.
    """

    def __init__(
        self,
        config: FitConfig,
        grid: PartitionGrid,
        static: psvgp.PSVGPStatic,
        state: psvgp.PSVGPState,
        cache: posterior.PosteriorCache | None = None,
    ):
        self.config = config
        self.grid = grid
        self.static = static
        self.state = state
        self._cache = cache
        self.cov_fn = static.cov_fn
        self.train_seconds: float | None = None
        self.refit_seconds: float | None = None

    @property
    def params(self) -> svgp.SVGPParams:
        return self.state.params

    @property
    def device(self) -> torch.device:
        return self.state.params.z.device

    @property
    def cache(self) -> posterior.PosteriorCache:
        if self._cache is None:
            self._cache = psvgp.posterior_cache(self.static, self.state)
        return self._cache

    def predict(self, points) -> tuple[torch.Tensor, torch.Tensor]:
        """Replicated blended prediction at (N, 2) points -> (mean, var)
        tensors on ``device`` (``blend.predict_blended``)."""
        return predict_blended(self.cache, self.cov_fn, self.grid, points)

    def to(self, device) -> "FittedPSVGP":
        """This model with every tensor on ``device`` (self if already there)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        static = _move(self.static, dev)._replace(cfg=_psvgp_config(self.config, dev))
        cache = None if self._cache is None else _move(self._cache, dev)
        return FittedPSVGP(self.config, self.grid, static, _move(self.state, dev), cache)

    def save(self, path: str) -> str:
        """Persist the serving artifact to ``path`` (a directory): the
        ``artifact.json`` manifest and the {params, cache} pytree, in the
        JAX package's format. Returns ``path``."""
        os.makedirs(path, exist_ok=True)
        manifest = {
            "format": ARTIFACT_FORMAT,
            "fit_config": self.config.to_dict(),
            "grid": {
                "gx": int(self.grid.gx),
                "gy": int(self.grid.gy),
                "wrap_x": bool(self.grid.wrap_x),
                "x_edges": np.asarray(self.grid.x_edges, np.float64).tolist(),
                "y_edges": np.asarray(self.grid.y_edges, np.float64).tolist(),
            },
        }
        with open(os.path.join(path, ARTIFACT_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        save_pytree(path, {"params": self.state.params, "cache": self.cache})
        return path

    def save_step(self, store_path: str, step: int, *, meta: dict | None = None) -> str:
        """Commit this model as simulation step ``step`` of a format=2
        append-only store (``checkpoint.store``): a full format=1 artifact in
        ``store_path/step_NNNNNNNN/``, then the atomic index append (the
        commit point). ``meta`` (plain JSON) rides along in the step's index
        entry; it defaults to the refit wall-clock. Returns the step dir."""
        dirname = artifact_store.step_dir_name(step)
        committed = (
            artifact_store.store_steps(store_path)
            if artifact_store.is_store(store_path)
            else []
        )
        if int(step) in committed or (committed and int(step) <= max(committed)):
            # fail BEFORE overwriting the step directory the index points at
            raise ValueError(
                f"step {step} cannot be committed to the store at "
                f"{store_path!r} (committed steps: {committed}) — the store "
                "is append-only, strictly increasing"
            )
        full = self.save(os.path.join(store_path, dirname))
        if meta is None and self.refit_seconds is not None:
            meta = {"refit_s": self.refit_seconds}
        artifact_store.commit_step(store_path, step, dirname, meta)
        return full

    @classmethod
    def from_numpy(
        cls,
        config: FitConfig,
        grid: PartitionGrid,
        arrays: dict,
        *,
        device=None,
    ) -> "FittedPSVGP":
        """Build a serving model from ``{pytree-path: ndarray}`` arrays (the
        keys of the JAX package's ``arrays.npz``). The ``params/*`` keys are
        required; the ``cache/*`` factors are used as they are when all are
        present (no refactorization), else factorized once on first use.
        Shapes are checked against ``config``; every array becomes a
        float32 tensor on ``device`` (``"cuda"`` unless told otherwise).
        Like a loaded JAX artifact it has no optimizer moments and no
        sampler tables (``psvgp.state_from_numpy`` carries a full training
        state)."""
        dev = resolve_device(device)
        if grid.gx != config.grid or grid.gy != config.grid:
            raise ValueError(
                f"grid {grid.gx}x{grid.gy} disagrees with FitConfig grid={config.grid}"
            )
        missing = [k for k in _PARAM_KEYS if k not in arrays]
        if missing:
            raise KeyError(f"artifact arrays miss {missing}")
        has_cache = all(k in arrays for k in _CACHE_KEYS)
        shapes = _shapes(config)
        for key in _PARAM_KEYS + (_CACHE_KEYS if has_cache else ()):
            shape = np.shape(arrays[key])
            if tuple(shape) != shapes[key]:
                raise ValueError(f"{key}: shape {shape} != expected {shapes[key]}")
        params = psvgp.params_from_numpy(arrays, "params", dev)
        cache = None
        if has_cache:

            def tensor(key):
                return torch.as_tensor(np.asarray(arrays[f"cache/{key}"], np.float32), device=dev)

            cache = posterior.PosteriorCache(
                z=tensor("z"), w=tensor("w"), u=tensor("u"), c=tensor("c"),
                cov=CovarianceParams(tensor("cov/log_lengthscale"), tensor("cov/log_variance")),
                log_beta=tensor("log_beta"),
            )
        static = psvgp.PSVGPStatic(
            cfg=_psvgp_config(config, dev), cov_fn=make_covariance(config.covariance),
            dist=None, perms=None, p_dir=None,  # training-time tables are not persisted
        )
        state = psvgp.PSVGPState(params=params, opt=AdamState(step=0, mu=None, nu=None), step=0)
        return cls(config, grid, static, state, cache)

    @classmethod
    def load(cls, path: str, *, step: int | None = None, device=None) -> "FittedPSVGP":
        """Restore a serving artifact written by either package — no
        retraining, no refactorization. ``path`` is a format=1 directory or
        a format=2 store (``step`` picks a committed step, latest when
        None)."""
        dev = resolve_device(device)
        path = _resolve_artifact_dir(path, step)
        with open(os.path.join(path, ARTIFACT_MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != ARTIFACT_FORMAT:
            raise ValueError(
                f"artifact at {path!r} has format {manifest.get('format')!r}; "
                f"this build reads format {ARTIFACT_FORMAT}"
            )
        config = FitConfig.from_dict(manifest["fit_config"])
        g = manifest["grid"]
        grid = PartitionGrid(
            gx=int(g["gx"]),
            gy=int(g["gy"]),
            x_edges=np.asarray(g["x_edges"], np.float64),
            y_edges=np.asarray(g["y_edges"], np.float64),
            wrap_x=bool(g["wrap_x"]),
        )
        return cls.from_numpy(config, grid, load_arrays(path), device=dev)


def _extract_xy(data: Any) -> tuple[np.ndarray, np.ndarray]:
    """The one data-adapter ``fit`` and ``refit`` share: an object with
    ``.x``/``.y`` attributes or an ``(x, y)`` tuple -> validated arrays."""
    if hasattr(data, "x") and hasattr(data, "y"):
        x, y = data.x, data.y
    else:
        x, y = data
    x = np.asarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != INPUT_DIM:
        raise ValueError(f"data x must be (N, {INPUT_DIM}), got {x.shape}")
    return x, np.asarray(y, np.float32)


def _train(
    config: FitConfig,
    x: np.ndarray,
    y: np.ndarray,
    init_state: psvgp.PSVGPState | None,
    device: torch.device,
) -> FittedPSVGP:
    """The shared training recipe behind ``fit`` and ``refit``: grid from
    the data's bounding box, padded partition storage on ``device``,
    ``psvgp.build``, then ``psvgp.fit`` for ``config.train_iters`` from
    either a fresh ``psvgp.init(config.seed)`` state (``init_state=None``)
    or the given warm one. One code path means refit-from-scratch equals
    fit bitwise by construction."""
    grid = make_grid(x, config.grid, config.grid)
    pdata = partition_data(x, y, grid, device=device)
    pcfg = _psvgp_config(config, device)
    static = psvgp.build(pcfg, pdata)
    if init_state is None:
        init_state = psvgp.init(config.seed, pcfg, pdata)
    t0 = time.perf_counter()
    state = psvgp.fit(static, init_state, pdata, config.train_iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fitted = FittedPSVGP(config, grid, static, state)
    fitted.train_seconds = time.perf_counter() - t0
    return fitted


def fit(config: FitConfig, data: Any, *, device=None, verbose: bool = False) -> FittedPSVGP:
    """Train a partitioned surface: ``FitConfig`` + data -> :class:`FittedPSVGP`.

    Args:
      config: the training recipe (grid side, m, delta, SGD budget, ...).
      data: an object with ``.x`` (N, 2) and ``.y`` (N,) attributes (e.g.
        ``repro_torch.data.spatial.SpatialDataset``) or an ``(x, y)`` tuple.
      device: where to train; ``None`` is ``"cuda"`` and raises without a
        GPU (pass ``"cpu"`` for the plain PyTorch lanes).
      verbose: print a one-line training summary.

    A fixed seed reproduces the same trained state bitwise on one device.
    """
    dev = resolve_device(device)
    x, y = _extract_xy(data)
    fitted = _train(config, x, y, None, dev)
    if verbose:
        print(
            f"trained P={fitted.grid.num_partitions} partitions, m={config.m}, "
            f"{config.train_iters} iters in {fitted.train_seconds:.1f} s on {dev}"
        )
    return fitted


def refit(
    fitted: FittedPSVGP,
    data: Any,
    config: RefitConfig | None = None,
    *,
    verbose: bool = False,
) -> FittedPSVGP:
    """One in-situ step: update ``fitted`` against a NEW time slice, on
    ``fitted.device``.

    Returns a NEW :class:`FittedPSVGP` (the input is never mutated). It
    reuses ``fitted.config`` with ``train_iters`` (and optionally
    ``learning_rate``) replaced by the refit budget; the grid and the
    sampler's tables are rebuilt from the new slice's bounding box.

    ``config.init``:
      * ``"warm"`` — previous params AND Adam moments carry over (moments
        re-zeroed with ``reset_optimizer``, or when the artifact was loaded
        and has none); the step counter carries over too, so the draws
        continue the sequence and never replay step 0's mini-batches.
      * ``"scratch"`` — re-initialize from the seed and run the SAME code
        path as :func:`fit`: with the full budget, bitwise equal to
        ``fit()`` on the new slice.
    """
    cfg = RefitConfig() if config is None else config
    fit_cfg = fitted.config
    if cfg.learning_rate is not None:
        fit_cfg = dataclasses.replace(fit_cfg, learning_rate=cfg.learning_rate)
    fit_cfg = dataclasses.replace(fit_cfg, train_iters=int(cfg.train_iters))
    x, y = _extract_xy(data)
    if cfg.init == "scratch":
        warm = None
    else:
        warm = fitted.state
        if cfg.reset_optimizer or warm.opt.mu is None:
            warm = psvgp.PSVGPState(params=warm.params, opt=adam_init(warm.params),
                                    step=warm.step)
    new = _train(fit_cfg, x, y, warm, fitted.device)
    new.refit_seconds = new.train_seconds
    if verbose:
        print(
            f"refit ({cfg.init}) P={new.grid.num_partitions} partitions, "
            f"{fit_cfg.train_iters} iters in {new.refit_seconds:.1f} s"
        )
    return new
