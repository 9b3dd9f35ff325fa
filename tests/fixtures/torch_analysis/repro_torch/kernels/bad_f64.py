"""RR003 fixture: float64 in a kernel hot path (suffix-matched)."""
import torch


def stage_factors(w):
    return w.double()  # <- a violation


def stage_queries(x):
    return x.to(torch.float64)  # <- a violation
