"""The port's front door: load an artifact, serve it.

    from repro_torch import api
    server = api.Server.from_artifact(path, api.ServeConfig(mode="sharded"))
    mean, var = server.submit(points)
"""
from repro_torch.api.config import FitConfig, ServeConfig
from repro_torch.api.fitted import FittedPSVGP
from repro_torch.api.server import Server

__all__ = ["FitConfig", "FittedPSVGP", "ServeConfig", "Server"]
