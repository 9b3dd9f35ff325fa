"""noqa fixture: the same violations as the bad files, each suppressed
with the per-line escape hatch — the linter must report nothing here."""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import build

DEVICE_INDEX = torch.cuda.current_device()  # repro: noqa-RR001
QUAD_NODES = torch.linspace(-1.0, 1.0, 8, device="cuda")  # repro: noqa-RR001
LIB = build.library()  # repro: noqa-RR001
dist.init_process_group("gloo")  # repro: noqa-RR001


@dataclasses.dataclass(frozen=True)
class KnownUnvalidated:  # repro: noqa-RR004
    mode: str = "replicated"
