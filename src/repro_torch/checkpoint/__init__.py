from repro_torch.checkpoint.checkpoint import (
    ARRAYS_FILE,
    MANIFEST_FILE,
    load_arrays,
    packb,
    save_pytree,
)

__all__ = ["ARRAYS_FILE", "MANIFEST_FILE", "load_arrays", "packb", "save_pytree"]
