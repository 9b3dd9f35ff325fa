"""RR002 fixture: a torch call smuggled into a declared pure-numpy routing
helper. The directory layout makes this file's path end with
``repro_torch/core/routing.py``, so the suffix-keyed rule config applies
to it exactly as it does to the real module. Every declared function
exists (a missing one is its own RR002 finding — not what this fixture
tests); only ``make_halo_stacker`` violates.
"""
import numpy as np


def owning_cells(grid, pts):
    return np.zeros(len(pts), np.int64), np.zeros(len(pts), np.int64)


def ceil_to(n, k):
    return -(-n // k) * k


def halo_ids(grid):
    return np.zeros((1, 9), np.int64)


def spill_assign(grid, own, ids, q_max):
    return own


def min_spill_q_max(grid, own, ids):
    return 1


def build_routing_table(grid, points):
    return None


def halo_slot_on_grid(grid):
    return np.ones((1, 9), bool)


def make_halo_stacker(grid):
    import torch

    def stack(xq):
        return torch.as_tensor(xq)  # <- the violation: routing went to torch

    return stack


def scatter_results(table, values):
    return np.asarray(values).ravel()


class StreamingQMax:
    def fit(self, counts):
        return int(counts.max())


class TwoLevelQMax(StreamingQMax):
    def fit_spill(self, grid, own, ids):
        return 1, own
