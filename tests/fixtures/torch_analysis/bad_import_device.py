"""RR001 fixture: a tensor created on a device and one moved there, at
module scope."""
import torch

QUAD_NODES = torch.linspace(-1.0, 1.0, 8, device="cuda")  # <- a violation
WEIGHTS = torch.ones(8).cuda()  # <- a violation


def uses_them(x):
    # lazy use is fine; only the module-scope creation above is the bug
    return torch.sum(QUAD_NODES * WEIGHTS * x)
