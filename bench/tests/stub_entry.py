"""A stub entry of another model family, for the harness's own tests: a
two-layer next-token MLP trained by SGD on tokens drawn from the seed,
plain PyTorch. The tests copy it into a copy of the benchmark as
``entries/<mix's entry>.py`` and add a configuration, a mix, limits and a
cell as new files and manifest entries, to show that the harness and every
reader take such a cell without an edit.

A unit is ``steps_per_unit`` training steps. Its shape names none of the
GP's sizes: it reports the step's FLOPs (6 per parameter of the products
per token) and the ``bf16`` peak. The check follows the first ``steps``
steps in float64 from the same seed and compares each step's loss.
"""
from __future__ import annotations

import contextlib
import time

import torch

from bench import profiles
from bench.seeds import sub_seed


def init(cfg: dict, seed: int, device: torch.device, dtype: torch.dtype) -> list[torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    V, D, H = cfg["vocab_size"], cfg["hidden_size"], cfg["intermediate_size"]
    flat = torch.randn(V * D + D * H + H * D + D * V, generator=gen, device=device)
    shapes = ((V, D), (D, H), (H, D), (D, V))
    parts = torch.split(flat, [a * b for a, b in shapes])
    return [(p.reshape(s) / s[0] ** 0.5).to(dtype).requires_grad_() for p, s in zip(parts, shapes,
                                                                                      strict=True)]


def loss(params: list[torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    emb, w1, w2, head = params
    h = emb[tokens[:, :-1]]
    h = h + torch.relu(h @ w1) @ w2
    logits = h @ head
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             tokens[:, 1:].reshape(-1))


def step(params: list[torch.Tensor], tokens: torch.Tensor, lr: float) -> float:
    value = loss(params, tokens)
    grads = torch.autograd.grad(value, params)
    with torch.no_grad():
        for p, g in zip(params, grads, strict=True):
            p -= lr * g
    return value.detach()


class Run:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "tokens"))
        self.tokens = torch.randint(0, cfg["vocab_size"], (mix["batch"], mix["seq_len"] + 1),
                                    generator=gen, device=device)
        self.params = init(cfg, seed, device, torch.float32)
        self.steps = int(limits["steps"])
        self.program = [float(step(self.params, self.tokens, cfg["lr"]))
                        for _ in range(self.steps)]
        V, D, H = cfg["vocab_size"], cfg["hidden_size"], cfg["intermediate_size"]
        tokens = mix["batch"] * mix["seq_len"]
        self.shape = {"batch": mix["batch"], "seq_len": mix["seq_len"],
                      "step_flops": 6 * tokens * (2 * D * H + D * V), "peak": cfg["peak"]}
        self.timing, self.losses = False, []

    def unit(self, k: int) -> dict:
        n = int(self.mix["steps_per_unit"])
        t0 = time.perf_counter()
        for _ in range(n):
            self.losses.append(step(self.params, self.tokens, self.cfg["lr"]))
        record = {"steps": n, "wall_s": time.perf_counter() - t0}
        if self.timing:
            record.update(device_ms=1e3 * record["wall_s"], device_steps=n)
        return record

    @contextlib.contextmanager
    def timed_units(self):
        self.timing = True
        try:
            yield
        finally:
            self.timing = False

    def profile(self) -> dict:
        n = int(self.mix["steps_per_unit"])
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step(self.params, self.tokens, self.cfg["lr"])
            window_s = time.perf_counter() - t0
        return profiles.reduce(prof, window_s, n)

    def failed_units(self) -> int:
        return int(sum(not torch.isfinite(v) for v in self.losses))

    def release(self) -> None:
        del self.params

    def check(self) -> dict[str, float]:
        params = init(self.cfg, self.seed, self.device, torch.float64)
        ref = [float(step(params, self.tokens, self.cfg["lr"])) for _ in range(self.steps)]
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(self.program, ref,
                                                                     strict=True))}


def setup(cfg: dict, mix: dict, limits: dict, seed: int, device: torch.device) -> Run:
    return Run(cfg, mix, limits, seed, device)
