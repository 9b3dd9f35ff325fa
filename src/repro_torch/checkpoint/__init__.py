from repro_torch.checkpoint.checkpoint import ARRAYS_FILE, load_arrays

__all__ = ["ARRAYS_FILE", "load_arrays"]
