"""RR001 fixture: CUDA initialized at module import time — every test on a
machine without a GPU, and every spawned rank before it joins its group,
would initialize (or fail to find) the card just by importing this."""
import torch

DEVICE_INDEX = torch.cuda.current_device()  # <- the violation


def on_card():
    return torch.cuda.is_available() and DEVICE_INDEX >= 0
