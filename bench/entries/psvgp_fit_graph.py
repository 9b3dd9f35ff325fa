"""Entry ``psvgp_fit_graph``: whole paper fits through the program's graph lane.

Set-up makes the mix's field from the seed, partitions it
(``partition.partition_data``), builds the step's tables (``psvgp.build``)
and drives the check's fit through the window's own call: from
``psvgp.init(s)``, ``psvgp.fit(..., 1, use_scan=True)`` (one eager step:
its Adam state gives the first gradient), then ``psvgp.fit(..., steps - 1,
use_scan=True)`` (eager warm-up, the capture and replays of the CUDA
graph). That also warms cuBLAS, cuSOLVER and the graph pool. A unit of the
window is one whole fit: ``psvgp.init(seed_k)`` then ``psvgp.fit(...,
iters, use_scan=True)`` and a synchronize. After the window the plain
reference follows the check's steps from the raw field.

With ``--trace 1`` the harness wraps ``psvgp.CapturedStep.replay`` with
CUDA events (the replays' device time of each fit, a unit's ``device_ms``
over its ``device_steps``), and profiles the last replays of one more fit.
The run's ``shape`` reports the step's FLOPs (``counts.step_flops``) and the
FP32 peak they are held to.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch

from bench import compare, counts, field, profiles
from bench.seeds import sub_seed

PROFILED_ITERS = 240  # the profiled fit's steps (at most a fit's); its last PROFILED_REPLAYS traced
PROFILED_REPLAYS = 100


class Timer:
    """CUDA events on the card, the host clock on the CPU; ``ms()`` after
    the work has been synchronized."""

    def __init__(self, device: torch.device):
        self.events = None
        if device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def start(self):
        if self.events:
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.events:
            self.events[1].record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.events:
            return self.events[0].elapsed_time(self.events[1])
        return 1e3 * (self.t1 - self.t0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_shape(P: int, B: int, m: int, d: int) -> dict:
    """The step's sizes, its FLOPs and the peak they are held to."""
    return {"P": P, "B": B, "m": m, "d": d, "step_flops": counts.step_flops(P, B, m, d),
            "peak": "fp32"}


def leaves(params) -> dict:
    """The program's parameter tree by leaf name."""
    return {"m_star": params.m_star, "s_tril": params.s_tril, "z": params.z,
            "log_lengthscale": params.cov.log_lengthscale,
            "log_variance": params.cov.log_variance, "log_beta": params.log_beta}


@contextlib.contextmanager
def wrapped_replay(psvgp, hook):
    """``psvgp.CapturedStep.replay(self, n)`` runs ``hook(replay, self, n)``."""
    original = psvgp.CapturedStep.replay

    def replay(self, n=1):
        return hook(original, self, n)

    psvgp.CapturedStep.replay = replay
    try:
        yield
    finally:
        psvgp.CapturedStep.replay = original


class Run:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: torch.device):
        from repro_torch.core import partition, psvgp, svgp
        from repro_torch.kernels import build

        self.psvgp, self.cfg, self.mix, self.seed, self.device = psvgp, cfg, mix, seed, device
        self.setup_phases: dict[str, float] = {}  # seconds by part of set-up
        mark = [time.perf_counter()]

        def lap(name: str) -> None:
            now = time.perf_counter()
            self.setup_phases[name], mark[0] = now - mark[0], now

        if device.type == "cuda":
            build.library()
        lap("kernels")
        self.x, self.y = field.make(mix, seed, device)
        lap("field")
        if device.type == "cuda":  # the peak from here on is the program's
            torch.cuda.reset_peak_memory_stats(device)
        gx, gy = mix["grid"]
        grid = partition.make_grid(self.x, gx, gy)
        self.data = partition.partition_data(self.x, self.y, grid,
                                              pad_multiple=int(mix["pad_multiple"]), device=device)
        self.pcfg = psvgp.PSVGPConfig(
            svgp=svgp.SVGPConfig(
                num_inducing=int(cfg["num_inducing"]), input_dim=int(cfg["input_dim"]),
                covariance=cfg["covariance"], jitter=float(cfg["jitter"]),
                whitened=bool(cfg["whitened"]), init_lengthscale=float(cfg["init_lengthscale"]),
                init_variance=float(cfg["init_variance"]), init_beta=float(cfg["init_beta"]),
                use_pallas=bool(cfg["use_pallas"]), likelihood=cfg["likelihood"]),
            delta=float(cfg["delta"]), batch_size=int(cfg["batch_size"]),
            learning_rate=float(cfg["learning_rate"]), comm=cfg["comm"],
            seed=sub_seed(seed, "draws"))
        self.static = psvgp.build(self.pcfg, self.data)
        lap("partition_and_build")
        self.iters = int(cfg["iters"])
        P, _, d = self.data.x.shape
        self.shape = step_shape(P, self.pcfg.batch_size, self.pcfg.svgp.num_inducing, d)
        self.steps = int(limits["steps"])
        self.check_seeds = (sub_seed(seed, "check:init"), sub_seed(seed, "check:draws"))
        self.program = self.drive(*self.check_seeds)
        self.finals: list = []
        self.pending: list = []
        sync(device)
        lap("check_drive")

    # ------------------------------------------------------------ the check's drive

    def drive(self, init_seed: int, draw_seed: int) -> dict:
        """The check's steps through the window's call; float64 CPU copies of
        the first gradient, the parameters at the start and at the end."""
        psvgp, b1 = self.psvgp, float(self.cfg["adam"]["b1"])
        state = psvgp.init(init_seed, self.pcfg, self.data)
        p0 = {k: v.double().cpu() for k, v in leaves(state.params).items()}
        state = psvgp.fit(self.static, state, self.data, 1, seed=draw_seed, use_scan=True)
        grad1 = {k: v.double().cpu() / (1.0 - b1) for k, v in leaves(state.opt.mu).items()}
        state = psvgp.fit(self.static, state, self.data, self.steps - 1, seed=draw_seed,
                          use_scan=True)
        return {"grad1": grad1, "p0": p0,
                "p_end": {k: v.double().cpu() for k, v in leaves(state.params).items()}}

    # ------------------------------------------------------------ the window

    def unit(self, k: int) -> dict:
        """One whole fit; {"steps", "wall_s"} and, when traced, its replays'
        device ms and count (``device_ms``, ``device_steps``)."""
        psvgp, fit_seed = self.psvgp, sub_seed(self.seed, f"fit:{k}")
        self.pending = []
        t0 = time.perf_counter()
        state = psvgp.init(fit_seed, self.pcfg, self.data)
        state = psvgp.fit(self.static, state, self.data, self.iters, seed=fit_seed, use_scan=True)
        sync(self.device)
        record = {"steps": self.iters, "wall_s": time.perf_counter() - t0}
        if self.pending:
            record["device_ms"] = sum(t.ms() for t, _ in self.pending)
            record["device_steps"] = sum(n for _, n in self.pending)
        self.finals.append(state.params)
        return record

    def timed_units(self):
        """Within it every replay call of the window is timed."""

        def hook(replay, captured, n):
            timer = Timer(self.device)
            timer.start()
            replay(captured, n)
            timer.stop()
            self.pending.append((timer, n))

        return wrapped_replay(self.psvgp, hook)

    def failed_units(self) -> int:
        """Window fits whose final parameters are not all finite."""
        bad = [torch.stack([torch.isfinite(v).all() for v in leaves(p).values()]).all()
               for p in self.finals]
        return int(sum(not bool(b) for b in bad))

    def profile(self) -> dict | None:
        """One more fit, its last PROFILED_REPLAYS replays under the profiler."""
        psvgp, box = self.psvgp, {}

        def hook(replay, captured, n):
            traced = min(n, PROFILED_REPLAYS)
            replay(captured, n - traced)
            sync(self.device)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                replay(captured, traced)
                sync(self.device)
                window_s = time.perf_counter() - t0
            box["record"] = profiles.reduce(prof, window_s, traced)

        fit_seed = sub_seed(self.seed, "profile")
        with wrapped_replay(psvgp, hook):
            state = psvgp.init(fit_seed, self.pcfg, self.data)
            psvgp.fit(self.static, state, self.data, min(PROFILED_ITERS, self.iters), seed=fit_seed,
                      use_scan=True)
        sync(self.device)
        return box.get("record")

    # ------------------------------------------------------------ after the window

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.data, self.static, self.finals
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict[str, float]:
        ref = importlib.import_module(f"bench.reference.{self.cfg['reference']}")
        reference = ref.follow(self.x, self.y, self.cfg, self.mix, *self.check_seeds, self.steps,
                               self.device)
        return compare.numbers(self.program, reference)


def setup(cfg: dict, mix: dict, limits: dict, seed: int, device: torch.device) -> Run:
    return Run(cfg, mix, limits, seed, device)
