"""psvgp-e3sm — the paper's own experiment configuration (§5).

Copy of ``repro.configs.psvgp_e3sm``: 48,602 observations, 20x20 = 400
partitions, m = 5 inducing points (the paper's in-situ operating point),
delta = 0.125, batch 32, learning rate 0.05, 2,500 iterations.
``psvgp(use_pallas=True)`` routes the ELBO's projection through the
port's CUDA kernel, as ``api.fit`` does on a CUDA device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.psvgp import PSVGPConfig
from repro_torch.core.svgp import SVGPConfig


@dataclasses.dataclass(frozen=True)
class E3SMExperiment:
    n_obs: int = 48602
    grid: tuple[int, int] = (20, 20)  # the paper's N_part = 400
    num_inducing: int = 5
    delta: float = 0.125  # the paper's best boundary-smoothness setting
    batch_size: int = 32
    learning_rate: float = 0.05  # delta's fig-4 effect needs converged local models
    iters: int = 2500
    probes_per_edge: int = 23  # ~the paper's 17,556 boundary locations
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_obs <= 0 or self.num_inducing <= 0:
            raise ValueError("n_obs and num_inducing must be positive")
        if len(self.grid) != 2 or min(self.grid) < 1:
            raise ValueError(f"grid must be two positive cell counts, got {self.grid}")
        if self.delta < 0 or self.learning_rate <= 0:
            raise ValueError("delta >= 0 and learning_rate > 0 required")
        if min(self.batch_size, self.probes_per_edge) <= 0 or self.iters < 0:
            raise ValueError("batch_size/probes_per_edge > 0 and iters >= 0 required")

    def psvgp(self, comm: str = "gather", use_pallas: bool = False) -> PSVGPConfig:
        return PSVGPConfig(
            svgp=SVGPConfig(num_inducing=self.num_inducing, input_dim=2, use_pallas=use_pallas),
            delta=self.delta,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            comm=comm,
            seed=self.seed,
        )


FULL = E3SMExperiment()


# dry-run variant: grid == device grid (one partition per device)
DRYRUN_SINGLE_POD = dataclasses.replace(FULL, grid=(16, 16))
DRYRUN_MULTI_POD = dataclasses.replace(FULL, grid=(16, 32))  # 32 rows = pod x data


def smoke() -> E3SMExperiment:
    return dataclasses.replace(FULL, n_obs=2000, grid=(4, 4), iters=100)
