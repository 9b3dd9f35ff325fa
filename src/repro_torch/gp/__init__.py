from repro_torch.gp.covariances import (
    CovarianceParams,
    ard_distance2,
    init_covariance_params,
    kdiag,
    make_covariance,
    matern32,
    matern52,
    periodic_lon_rbf,
    rbf,
)
from repro_torch.gp.exact import exact_gp_logml, exact_gp_predict
from repro_torch.gp.likelihoods import gaussian_expected_loglik, poisson_expected_loglik

__all__ = [
    "CovarianceParams",
    "ard_distance2",
    "exact_gp_logml",
    "exact_gp_predict",
    "gaussian_expected_loglik",
    "init_covariance_params",
    "kdiag",
    "make_covariance",
    "matern32",
    "matern52",
    "periodic_lon_rbf",
    "poisson_expected_loglik",
    "rbf",
]
