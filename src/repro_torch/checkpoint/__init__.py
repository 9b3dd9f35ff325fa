from repro_torch.checkpoint import store
from repro_torch.checkpoint.checkpoint import (
    ARRAYS_FILE,
    MANIFEST_FILE,
    latest_step,
    load_arrays,
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)
from repro_torch.codec import packb, unpackb

__all__ = [
    "ARRAYS_FILE",
    "MANIFEST_FILE",
    "latest_step",
    "load_arrays",
    "load_pytree",
    "load_train_state",
    "packb",
    "save_pytree",
    "save_train_state",
    "store",
    "unpackb",
]
