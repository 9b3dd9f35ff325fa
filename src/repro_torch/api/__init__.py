"""The port's front door: train a surface, save it, load it, serve it.

    from repro_torch import api
    fitted = api.fit(api.FitConfig(grid=20, m=5), (x, y))          # on "cuda"
    server = api.Server(fitted, api.ServeConfig(mode="sharded"))
    mean, var = server.submit(points)
"""
from repro_torch.api.config import FitConfig, RefitConfig, ServeConfig
from repro_torch.api.fitted import FittedPSVGP, fit, refit
from repro_torch.api.server import Server

__all__ = ["FitConfig", "FittedPSVGP", "RefitConfig", "ServeConfig", "Server", "fit", "refit"]
