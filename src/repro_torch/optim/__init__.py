from repro_torch.optim.adam import AdamState, adam_init, adam_update, tree_map

__all__ = ["AdamState", "adam_init", "adam_update", "tree_map"]
