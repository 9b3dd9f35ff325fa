"""RR001 fixture: a process group joined at import — a spawned rank that
imports this joins before it has its rank, and a test process hangs."""
import torch.distributed as dist

dist.init_process_group("gloo")  # <- the violation


def rank():
    return dist.get_rank()
