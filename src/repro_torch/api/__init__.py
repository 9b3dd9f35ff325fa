"""The port's front door: train a surface, save it, load it, serve it.

    from repro_torch import api
    fitted = api.fit(api.FitConfig(grid=20, m=5), (x, y))          # on "cuda"
    server = api.Server(fitted, api.ServeConfig(mode="sharded"))
    mean, var = server.submit(points)

and the in-situ loop of it:

    new = api.refit(fitted, next_slice, api.RefitConfig(train_iters=150))
    new.save_step(store, t)                       # format=2 append-only store
    server.swap(new, version=t)                   # zero-downtime hot swap

with many small clients in front (``api.FrontDoor``, in process, or
``repro_torch.net``, over HTTP).
"""
from repro_torch.api.config import (
    FitConfig,
    FrontDoorConfig,
    NetConfig,
    RefitConfig,
    ServeConfig,
    load_session,
)
from repro_torch.api.fitted import FittedPSVGP, fit, peek_fit_config, peek_steps, refit
from repro_torch.api.frontdoor import FrontDoor, RequestRejected, RequestTooLarge
from repro_torch.api.server import Server

__all__ = [
    "FitConfig",
    "FrontDoor",
    "FrontDoorConfig",
    "NetConfig",
    "RefitConfig",
    "RequestRejected",
    "RequestTooLarge",
    "ServeConfig",
    "FittedPSVGP",
    "Server",
    "fit",
    "load_session",
    "peek_fit_config",
    "peek_steps",
    "refit",
]
