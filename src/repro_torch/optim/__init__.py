from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_update,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedule import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "adamw_update",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
    "tree_leaves",
    "tree_map",
]
