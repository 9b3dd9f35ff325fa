from repro_torch.gp.covariances import (
    CovarianceParams,
    kdiag,
    make_covariance,
    matern32,
    matern52,
    periodic_lon_rbf,
    rbf,
)
from repro_torch.gp.exact import exact_gp_logml, exact_gp_predict

__all__ = [
    "CovarianceParams",
    "exact_gp_logml",
    "exact_gp_predict",
    "kdiag",
    "make_covariance",
    "matern32",
    "matern52",
    "periodic_lon_rbf",
    "rbf",
]
