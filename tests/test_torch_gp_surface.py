"""``repro_torch.gp``'s public surface against ``repro.gp``'s.

  * every name of JAX's ``repro.gp.__all__`` is exported by the port, and
    the port's own extras (``kdiag``, ``periodic_lon_rbf``) stay;
  * ``init_covariance_params`` equals JAX's bitwise at d = 2 and 3, at the
    arguments JAX's tests and the SVGP defaults use. At other arguments
    they agree within 2**-23 max(1, |log x|): the port takes the float64
    log of the argument and rounds once, JAX rounds the argument to
    float32 first (up to 2**-24 relative, as much absolute in the log)
    and XLA's float32 log is not correctly rounded (0.7 is an argument
    where they differ);
  * ``svgp.init_svgp_params`` builds its covariance leaves through it,
    with the bits it had before (``math.log`` rounded to float32).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import repro.gp as jgp
import repro_torch.gp as tgp


def test_port_exports_every_name_of_jax_gp():
    assert set(jgp.__all__) <= set(tgp.__all__)
    assert {"kdiag", "periodic_lon_rbf"} <= set(tgp.__all__)
    for name in tgp.__all__:
        assert getattr(tgp, name) is not None


@pytest.mark.parametrize("lengthscale,variance", [(1.0, 1.0), (0.3, 1.5), (0.5, 2.0)])
@pytest.mark.parametrize("d", [2, 3])
def test_init_covariance_params_is_jax_bitwise(d, lengthscale, variance):
    want = jgp.init_covariance_params(d, lengthscale, variance)
    got = tgp.init_covariance_params(d, lengthscale, variance)
    assert got.log_lengthscale.shape == (d,) and got.log_variance.shape == ()
    assert got.log_lengthscale.dtype == got.log_variance.dtype == torch.float32
    np.testing.assert_array_equal(got.log_lengthscale.numpy(), np.asarray(want.log_lengthscale))
    np.testing.assert_array_equal(got.log_variance.numpy(), np.asarray(want.log_variance))


def test_init_covariance_params_within_rounding_of_jax_elsewhere():
    for v in np.random.default_rng(0).uniform(0.01, 10.0, 200):
        want = np.asarray(jgp.init_covariance_params(2, float(v), float(v)).log_lengthscale)
        got = tgp.init_covariance_params(2, float(v), float(v)).log_lengthscale.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0**-23 * max(1.0, abs(math.log(v))))
    got = tgp.init_covariance_params(3, 2.0, dtype=torch.float64, device="cpu")
    assert got.log_lengthscale.dtype == torch.float64
    assert float(got.log_lengthscale[0]) == math.log(2.0)


def test_svgp_init_builds_its_covariance_through_it():
    from repro_torch.core import svgp

    cfg = svgp.SVGPConfig(num_inducing=3, input_dim=2, init_lengthscale=0.7, init_variance=1.3)
    x = torch.rand((4, 10, 2), generator=torch.Generator().manual_seed(0))
    p = svgp.init_svgp_params(torch.Generator().manual_seed(1), cfg, x)
    assert p.cov.log_lengthscale.shape == (4, 2) and p.cov.log_variance.shape == (4,)
    # the bits the init had before: math.log rounded once to float32
    assert torch.equal(p.cov.log_lengthscale, torch.full((4, 2), math.log(0.7)))
    assert torch.equal(p.cov.log_variance, torch.full((4,), math.log(1.3)))
    one = tgp.init_covariance_params(2, 0.7, 1.3)
    assert all(torch.equal(row, one.log_lengthscale) for row in p.cov.log_lengthscale)
