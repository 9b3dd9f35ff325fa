"""``psvgp.fit(use_scan=True)``, the captured-step lane of the training loop
(the counterpart of the JAX package's ``use_scan``), against the plain loop.

On the CPU the captured step (``psvgp.CapturedStep``) runs eagerly over its
static buffers, its counters advancing in place as a CUDA graph advances
them: the fit is bitwise the plain loop's, for both comm modes and both
projection lanes, and a resumed fit is bitwise the uninterrupted one. On
the card (``cuda``-marked, skipped without a GPU): the CUDA graph lane
bitwise the eager lane (``use_pallas`` on and off, both comm modes), one
projection launch per replayed step (the wrapper's count and the
profiler's), no host synchronization in a replay, and a capture that fails
raises. Small sizes: grid 3, 400 points, m 4, B 8 on the CPU.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core import partition, psvgp, svgp
from repro_torch.data.spatial import e3sm_like_field
from repro_torch.kernels import launches, svgp_proj


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(comm: str, use_pallas: bool, device, grid: int = 3, n: int = 400, m: int = 4,
             batch: int = 8):
    ds = e3sm_like_field(n=n, seed=0)
    data = partition.partition_data(ds.x, ds.y, partition.make_grid(ds.x, grid, grid),
                                    device=device)
    cfg = psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(num_inducing=m, input_dim=2, use_pallas=use_pallas),
        delta=0.25, batch_size=batch, learning_rate=0.05, comm=comm, seed=0,
    )
    return psvgp.build(cfg, data), psvgp.init(0, cfg, data), data


def _bitwise(a: psvgp.PSVGPState, b: psvgp.PSVGPState) -> list[str]:
    """The leaves (params, Adam moments, both counters) that differ."""
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    return [k for k in fa if not np.array_equal(fa[k], fb[k])]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel-lane"])
@pytest.mark.parametrize("comm", ["gather", "ppermute"])
def test_use_scan_fit_is_bitwise_the_plain_fit(comm, use_pallas):
    static, state, data = _problem(comm, use_pallas, "cpu")
    plain = psvgp.fit(static, state, data, 12)
    scan = psvgp.fit(static, state, data, 12, use_scan=True)
    assert _bitwise(scan, plain) == []
    assert type(scan.step) is int and scan.step == scan.opt.step == 12


@pytest.mark.parametrize("comm", ["gather", "ppermute"])
def test_use_scan_fit_resumed_equals_the_uninterrupted_one(comm):
    """5 + 7 steps through the captured lane == 12 in one go: step t's
    draws and bias corrections depend on the counters alone."""
    static, state, data = _problem(comm, False, "cpu")
    whole = psvgp.fit(static, state, data, 12, use_scan=True)
    half = psvgp.fit(static, state, data, 5, use_scan=True)
    resumed = psvgp.fit(static, half, data, 7, use_scan=True)
    assert _bitwise(resumed, whole) == []
    assert resumed.step == 12
    # an optimizer reset keeps the draw counter and restarts Adam's
    reset = half._replace(opt=half.opt._replace(step=0))
    again = psvgp.fit(static, reset, data, 7, use_scan=True)
    assert (again.step, again.opt.step) == (12, 7)
    assert _bitwise(again, psvgp.fit(static, reset, data, 7)) == []


def test_captured_step_advances_its_counters_in_place():
    """Three replays of the captured step == three plain steps from the
    same state; the buffers' counters moved, the state returned is a copy;
    fits shorter than the warm-up and log_every run the plain loop."""
    static, state, data = _problem("gather", False, "cpu")
    dev_state = psvgp.device_counters(state, data.x.device)
    captured = psvgp.CapturedStep(static, dev_state, data)
    captured.replay(3)
    got = captured.state()
    assert int(got.step) == int(got.opt.step) == 3
    assert got.params.m_star.data_ptr() != captured.buffers.params.m_star.data_ptr()
    want = state
    for _ in range(3):
        want, _loss = psvgp.train_step(static, want, data)
    assert _bitwise(got, want) == []
    short = psvgp.fit(static, state, data, psvgp.WARMUP_STEPS - 1, use_scan=True)
    assert _bitwise(short, psvgp.fit(static, state, data, psvgp.WARMUP_STEPS - 1)) == []
    logged = psvgp.fit(static, state, data, 6, log_every=3, use_scan=True)
    assert _bitwise(logged, psvgp.fit(static, state, data, 6)) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel-lane"])
@pytest.mark.parametrize("comm", ["gather", "ppermute"])
def test_cuda_graph_lane_is_bitwise_the_eager_lane(cuda_device, comm, use_pallas):
    static, state, data = _problem(comm, use_pallas, cuda_device, grid=4, n=2000, m=5,
                                   batch=16)
    launches.reset()
    graph = psvgp.fit(static, state, data, 40, use_scan=True)
    n_proj = svgp_proj.LAUNCHES["svgp_projection"]
    eager = psvgp.fit(static, state, data, 40)
    assert _bitwise(graph, eager) == []
    assert n_proj == (40 if use_pallas else 0)
    resumed = psvgp.fit(static, psvgp.fit(static, state, data, 17, use_scan=True), data, 23,
                        use_scan=True)
    assert _bitwise(resumed, graph) == []


@pytest.mark.cuda
def test_cuda_replays_launch_the_projection_once_and_never_synchronize(cuda_device):
    static, state, data = _problem("gather", True, cuda_device, grid=4, n=2000, m=5, batch=16)
    state = psvgp.fit(static, state, data, psvgp.WARMUP_STEPS, use_scan=True)
    captured = psvgp.CapturedStep(static, psvgp.device_counters(state, cuda_device), data)
    assert captured.captured == {"svgp_projection": 1, "adam_update": 1, "minibatch_draws": 1}
    torch.cuda.synchronize()
    before = svgp_proj.LAUNCHES["svgp_projection"]
    torch.cuda.set_sync_debug_mode("warn")  # CUDA warns at every host synchronization
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            captured.replay(10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    assert syncs == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        captured.replay(10)
        torch.cuda.synchronize()
    assert svgp_proj.LAUNCHES["svgp_projection"] == before + 20
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if on_card:  # the profiler saw the card: count the kernel itself
        assert sum("projection" in e.name for e in on_card) == 10
    assert int(captured.state().step) == psvgp.WARMUP_STEPS + 20


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda_device, monkeypatch):
    """A step that cannot be captured (here: it reads the loss back to the
    host) raises out of ``fit``; nothing continues eagerly. Last in the
    file: the capture's failure leaves the stream out of capture mode."""
    static, state, data = _problem("gather", False, cuda_device, grid=4, n=2000, m=5, batch=16)
    inner = psvgp.train_step

    def reads_back(*args, **kwargs):
        new, loss = inner(*args, **kwargs)
        loss.item()  # a host synchronization, refused inside a capture
        return new, loss

    monkeypatch.setattr(psvgp, "train_step", reads_back)
    with pytest.raises(RuntimeError):
        psvgp.fit(static, state, data, 10, use_scan=True)
    monkeypatch.setattr(psvgp, "train_step", inner)
    torch.cuda.synchronize()
    assert psvgp.fit(static, state, data, 4, use_scan=True).step == 4
