from repro_torch.gp.covariances import (
    CovarianceParams,
    kdiag,
    make_covariance,
    matern32,
    matern52,
    periodic_lon_rbf,
    rbf,
)

__all__ = [
    "CovarianceParams",
    "kdiag",
    "make_covariance",
    "matern32",
    "matern52",
    "periodic_lon_rbf",
    "rbf",
]
