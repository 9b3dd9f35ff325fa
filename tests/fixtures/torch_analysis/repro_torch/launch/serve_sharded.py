"""RR002 fixture, the mesh lane's route stage: a rank's route copies its
halo block to the card before the pipelined loop's overlap window ends.
The path ends with ``repro_torch/launch/serve_sharded.py``; every declared
function exists and only ``make_mesh_request_stages.route`` violates."""
import numpy as np
import torch


def make_router(grid, *, policy=None, q_max=None):
    def route_table(q):
        return np.asarray(q, np.float32)

    return route_table


def make_request_stages(grid, blend_fn, cache):
    def route(q):
        return np.asarray(q, np.float32), None

    return route


def make_mesh_request_stages(grid, program, cache, mesh):
    def route(q):
        return torch.from_numpy(np.asarray(q, np.float32))  # <- the violation

    return route
