from repro_torch.sharding.rules import (
    batch_pspec,
    cache_pspecs,
    data_axes,
    gp_stacked_pspecs,
    local_shape,
    params_pspecs,
    state_pspecs,
    to_placements,
)

__all__ = ["params_pspecs", "state_pspecs", "batch_pspec", "cache_pspecs", "data_axes",
           "gp_stacked_pspecs", "to_placements", "local_shape"]
