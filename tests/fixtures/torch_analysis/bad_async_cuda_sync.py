"""RR005 fixture, the port's device sync: a CUDA synchronize and an
event's ``.synchronize()`` inside ``async def`` — the loop thread waits
for the card and every client stalls."""
import torch


async def collect(pending):
    torch.cuda.synchronize()  # <- a violation
    pending.done_event.synchronize()  # <- a violation
    return pending.host
