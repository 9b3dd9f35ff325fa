"""Async rules suppressed in place: the port's device syncs, each under
the per-line escape hatch; stripping the comments brings them back."""
import torch


async def collect(pending):
    torch.cuda.synchronize()  # repro: noqa-RR005
    pending.done_event.synchronize()  # repro: noqa-RR005
    return pending.host
