from repro_torch.runtime.steps import (
    TrainState,
    cross_entropy,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "cross_entropy",
    "init_train_state",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
]
