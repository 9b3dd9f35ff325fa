"""``FittedPSVGP`` — a trained partitioned surface, loaded for serving.

The artifact format is the JAX package's (``repro.api.FittedPSVGP.save``):
a directory with ``artifact.json`` (the FitConfig and the grid geometry,
plain JSON) and ``arrays.npz`` keyed by pytree path — ``params/m_star``,
``params/s_tril``, ``params/z``, ``params/cov/log_lengthscale``,
``params/cov/log_variance``, ``params/log_beta`` and the cached factors
``cache/{z,w,u,c,cov/...,log_beta}``. numpy reads it all, so a model
trained with JAX serves here on a machine without JAX:

    fitted = FittedPSVGP.load("runs/e3sm_t42/")            # on "cuda"
    server = Server(fitted, ServeConfig(mode="sharded"))

:meth:`FittedPSVGP.from_numpy` is the one function that carries the JAX
package's parameters and factors into tensors; ``load`` is the manifest
plus ``np.load`` plus ``from_numpy``. Training (``fit``/``refit``) and
``save`` come with the training slice.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.checkpoint import load_arrays
from repro_torch.checkpoint import store as artifact_store
from repro_torch.core import posterior, svgp
from repro_torch.core.blend import predict_blended
from repro_torch.core.partition import PartitionGrid
from repro_torch.device import resolve_device
from repro_torch.gp.covariances import CovarianceParams, make_covariance

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


class FittedPSVGP:
    """A trained partitioned surface: config + grid + params + cached factors,
    as tensors on one device.

    Attributes:
      config: the :class:`FitConfig` that produced it.
      grid:   the ``PartitionGrid`` the model was trained on.
      params: the P-stacked ``svgp.SVGPParams``.
      cache:  the P-stacked ``PosteriorCache`` — the artifact's factors,
        or factorized once from ``params`` when the arrays carry none.
      device: where every tensor lives.
    """

    def __init__(
        self,
        config: FitConfig,
        grid: PartitionGrid,
        params: svgp.SVGPParams,
        cache: posterior.PosteriorCache | None,
        device: torch.device,
    ):
        self.config = config
        self.grid = grid
        self.params = params
        self._cache = cache
        self.device = device
        self.cov_fn = make_covariance(config.covariance)

    @property
    def cache(self) -> posterior.PosteriorCache:
        if self._cache is None:
            self._cache = posterior.build_cache_stacked(
                self.params, self.cov_fn,
                jitter=self.config.jitter, whitened=self.config.whitened,
            )
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

        def move(t):
            return t.to(dev)

        params = svgp.SVGPParams(
            m_star=move(self.params.m_star), s_tril=move(self.params.s_tril),
            z=move(self.params.z),
            cov=CovarianceParams(
                move(self.params.cov.log_lengthscale), move(self.params.cov.log_variance)
            ),
            log_beta=move(self.params.log_beta),
        )
        cache = None if self._cache is None else posterior.map_cache(move, self._cache)
        return FittedPSVGP(self.config, self.grid, params, cache, dev)

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
        float32 tensor on ``device`` (``"cuda"`` unless told otherwise)."""
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

        def tensor(key):
            a = np.asarray(arrays[key])
            if tuple(a.shape) != shapes[key]:
                raise ValueError(f"{key}: shape {a.shape} != expected {shapes[key]}")
            return torch.as_tensor(a.astype(np.float32), device=dev)

        params = svgp.SVGPParams(
            m_star=tensor("params/m_star"),
            s_tril=tensor("params/s_tril"),
            z=tensor("params/z"),
            cov=CovarianceParams(
                tensor("params/cov/log_lengthscale"), tensor("params/cov/log_variance")
            ),
            log_beta=tensor("params/log_beta"),
        )
        cache = None
        if has_cache:
            cache = posterior.PosteriorCache(
                z=tensor("cache/z"), w=tensor("cache/w"), u=tensor("cache/u"),
                c=tensor("cache/c"),
                cov=CovarianceParams(
                    tensor("cache/cov/log_lengthscale"), tensor("cache/cov/log_variance")
                ),
                log_beta=tensor("cache/log_beta"),
            )
        return cls(config, grid, params, cache, dev)

    @classmethod
    def load(cls, path: str, *, step: int | None = None, device=None) -> "FittedPSVGP":
        """Restore a serving artifact written by the JAX package — no
        retraining, no refactorization. ``path`` is a format=1 directory
        or a format=2 store (``step`` picks a committed step, latest when
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
