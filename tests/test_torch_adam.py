"""The Adam update (``optim.adam_update``) and its CUDA kernel
(``kernels/adam.py``, ``csrc/adam.cu``).

On the CPU: the plain formula with a destination writes the bits it
returns without one, in place too, and leaves the inputs as they were
without one; the captured step on the CPU writes its own buffers; the
kernel's wrapper refuses what it does not take, and ``adam_update`` a
device that is neither CUDA nor the CPU; Adam's counter is in the launch
registry. On the card
(``cuda``-marked, skipped without a GPU): the kernel bitwise the plain
formula at PSVGP's leaf shapes (P in {1, 400, 6,400}, m in {5, 20}, d = 2)
at steps 1, 2 and 2,500, host and device counters, out of place and in
place; a non-contiguous input copied and a non-contiguous destination
refused; a 2,500-step eager fit bitwise the same fit through the plain
formula (every bias correction of the benchmark's fits); and the captured
step: one Adam launch a replay, the 20 copies of the new state gone, no
host synchronization, bitwise the eager fit. No JAX here: the reference
is the plain formula.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core import partition, psvgp, svgp
from repro_torch.core.svgp import SVGPParams
from repro_torch.data.spatial import e3sm_like_field
from repro_torch.gp.covariances import CovarianceParams
from repro_torch.kernels import adam as adam_kernel
from repro_torch.kernels import launches
from repro_torch.optim import AdamState, adam_update, tree_leaves, tree_map
from repro_torch.optim.adam import plain_adam_update

LR = 0.05  # the paper's E3SM operating point


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(P: int, m: int, d: int, gen: torch.Generator, scale: float = 1.0):
    def r(*shape):
        return scale * torch.randn(shape, generator=gen)

    return SVGPParams(m_star=r(P, m), s_tril=r(P, m, m), z=r(P, m, d),
                      cov=CovarianceParams(r(P, d), r(P)), log_beta=r(P))


def _state(P: int, m: int, d: int, step, seed: int = 0, device="cpu"):
    """Seeded params, grads and Adam state of PSVGP's leaf shapes, moved
    to ``device`` (nu >= 0, as a second moment is)."""
    gen = torch.Generator().manual_seed(seed)
    params = _leaves(P, m, d, gen)
    grads = _leaves(P, m, d, gen, 0.3)
    mu = _leaves(P, m, d, gen, 0.1)
    nu = tree_map(torch.abs, _leaves(P, m, d, gen, 0.05))
    move = (lambda t: t.to(device))
    return tree_map(move, params), tree_map(move, grads), AdamState(step, tree_map(move, mu),
                                                                      tree_map(move, nu))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _bits(result) -> list[np.ndarray]:
    """Every leaf of (params, AdamState) as numpy, the counter as an int64
    array."""
    params, opt = result
    out = [t.detach().cpu().numpy() for t in tree_leaves((params, opt.mu, opt.nu))]
    return out + [np.asarray(int(opt.step), np.int64)]


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b, strict=True))


def _counter(n: int, kind: str, device):
    return n if kind == "int" else torch.tensor(n, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# on the CPU: the plain formula, its destination, and the wrapper's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter", ["int", "tensor"])
def test_adam_destination_writes_the_bits_it_returns_without_one(counter):
    params, grads, state = _state(4, 5, 2, _counter(6, counter, "cpu"))
    before = _bits((params, state))
    want = adam_update(params, grads, state, lr=LR)
    assert _same(_bits((params, state)), before)  # inputs untouched
    assert int(want[1].step) == 7

    def dest_counter(n):
        return torch.tensor(n, dtype=torch.int64)

    fresh = (tree_map(torch.zeros_like, params),
             AdamState(dest_counter(0), tree_map(torch.zeros_like, state.mu),
                       tree_map(torch.zeros_like, state.nu)))
    got = adam_update(params, grads, state, lr=LR, out=fresh)
    assert got is fresh and _same(_bits(got), _bits(want))
    # in place: the destination is the input state itself (a device counter)
    p2, s2 = _clone(params), AdamState(dest_counter(6), _clone(state.mu), _clone(state.nu))
    inplace = (p2, s2)
    got = adam_update(p2, grads, s2, lr=LR, out=inplace)
    assert got is inplace and _same(_bits(got), _bits(want))
    assert p2.m_star.data_ptr() == got[0].m_star.data_ptr()


def test_adam_update_on_the_cpu_is_the_plain_formula():
    params, grads, state = _state(3, 4, 2, 0)
    for _ in range(3):
        got = adam_update(params, grads, state, lr=LR)
        want = plain_adam_update(params, grads, state, lr=LR)
        assert _same(_bits(got), _bits(want))
        params, state = got
    assert state.step == 3


def test_captured_step_on_the_cpu_writes_its_buffers_in_place():
    """The CPU's captured step: the Adam update's destination is the
    buffers themselves, so every leaf keeps its storage, the counters
    advance in it, and ``state()`` hands out copies."""
    ds = e3sm_like_field(n=400, seed=0)
    data = partition.partition_data(ds.x, ds.y, partition.make_grid(ds.x, 3, 3), device="cpu")
    cfg = psvgp.PSVGPConfig(svgp=svgp.SVGPConfig(num_inducing=4, input_dim=2), delta=0.25,
                            batch_size=8, learning_rate=LR, seed=0)
    static, state = psvgp.build(cfg, data), psvgp.init(0, cfg, data)
    captured = psvgp.CapturedStep(static, psvgp.device_counters(state, "cpu"), data)
    ptrs = [t.data_ptr() for t in tree_leaves(captured.buffers)]
    captured.replay(2)
    assert captured.captured == {}  # the CPU launches no kernel
    assert [t.data_ptr() for t in tree_leaves(captured.buffers)] == ptrs
    assert int(captured.buffers.step) == int(captured.buffers.opt.step) == 2
    got = captured.state()
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(tree_leaves(got), tree_leaves(captured.buffers), strict=True))
    assert type(got) is psvgp.PSVGPState  # a copy is written in place by no step
    start = flatten(state)
    want = state
    for _ in range(2):
        want, _loss = psvgp.train_step(static, want, data)
    fa, fb = flatten(got), flatten(want)
    assert [k for k in fa if not np.array_equal(fa[k], fb[k])] == []
    now = flatten(state)  # an eager step leaves its input as it was
    assert [k for k in start if not np.array_equal(start[k], now[k])] == []


def test_launch_counts_come_back_from_a_capture_and_count_its_replays():
    """``kernels/launches.py``, as ``CapturedStep`` runs it on Adam's
    counter: the launch made during a capture is taken back out and
    becomes what one replay launches; ``launches.reset`` zeroes it."""
    launches.reset()
    adam_kernel.LAUNCHES["adam_update"] += 3
    before = launches.counts()
    adam_kernel.LAUNCHES["adam_update"] += 1  # the wrapper's call while the graph was captured
    one = launches.captured_launches(before)
    assert one == {"adam_update": 1} and adam_kernel.LAUNCHES == {"adam_update": 3}
    launches.count_replays(one, 10)
    assert adam_kernel.LAUNCHES == {"adam_update": 13}
    launches.reset()
    assert adam_kernel.LAUNCHES == {"adam_update": 0}


def test_adam_update_refuses_a_device_with_no_lane():
    """``kernels.ops.on_cuda`` decides, as for the other kernels: a meta
    tree is neither the kernel's nor the plain formula's."""
    params, grads, state = _state(2, 3, 2, 0, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        adam_update(params, grads, state, lr=LR)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    params, grads, state = _state(2, 3, 2, 0)
    leaves = [tree_leaves(t) for t in (params, grads, state.mu, state.nu)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        adam_kernel.adam_update(*leaves, *leaves[:1], *leaves[2:], 0, None, lr=LR, b1=0.9,
                                b2=0.999, eps=1e-8)
    many = [[torch.zeros(1)] * (adam_kernel.MAX_LEAVES + 1)] * 7
    with pytest.raises(ValueError, match="leaves"):
        adam_kernel.adam_update(*many, 0, None, lr=LR, b1=0.9, b2=0.999, eps=1e-8)
    with pytest.raises(ValueError, match="leaves"):
        adam_kernel.adam_update(*leaves, *leaves[:1], *leaves[2:3], leaves[3][:-1], 0, None,
                                lr=LR, b1=0.9, b2=0.999, eps=1e-8)
    assert adam_kernel.LAUNCHES == {"adam_update": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [False, True], ids=["out-of-place", "in-place"])
@pytest.mark.parametrize("counter", ["int", "tensor"])
@pytest.mark.parametrize("t", [1, 2, 2500])
@pytest.mark.parametrize("m", [5, 20])
@pytest.mark.parametrize("P", [1, 400, 6400])
def test_cuda_kernel_is_bitwise_the_plain_formula(cuda_device, P, m, t, counter, inplace):
    params, grads, state = _state(P, m, 2, _counter(t - 1, counter, cuda_device), seed=P + m + t,
                                  device=cuda_device)
    want = plain_adam_update(params, grads, state, lr=LR)
    before = _bits((params, state))
    launches = adam_kernel.LAUNCHES["adam_update"]
    if not inplace:
        got = adam_update(params, grads, state, lr=LR)
        assert _same(_bits((params, state)), before)  # the inputs untouched
    else:  # the destination is the input (a device counter: a host one cannot be written)
        if not isinstance(state.step, torch.Tensor):
            state = state._replace(step=torch.tensor(state.step, device=cuda_device))
        out = (params, state)
        got = adam_update(params, grads, state, lr=LR, out=out)
        assert got is out and got[0].s_tril.data_ptr() == params.s_tril.data_ptr()
    torch.cuda.synchronize()
    assert adam_kernel.LAUNCHES["adam_update"] == launches + 1
    assert _same(_bits(got), _bits(want))
    assert int(got[1].step) == t
    assert inplace or type(got[1].step) is type(want[1].step)  # a host counter stays one


@pytest.mark.cuda
def test_cuda_kernel_copies_a_strided_input_and_refuses_a_strided_destination(cuda_device):
    params, grads, state = _state(400, 5, 2, 4, device=cuda_device)
    strided = grads._replace(s_tril=grads.s_tril.transpose(1, 2).contiguous().transpose(1, 2))
    assert not strided.s_tril.is_contiguous()
    want = plain_adam_update(params, strided, state, lr=LR)
    got = adam_update(params, strided, state, lr=LR)
    assert _same(_bits(got), _bits(want))
    bad = params._replace(s_tril=params.s_tril.transpose(1, 2))
    out = (bad, state._replace(step=torch.tensor(0, device=cuda_device)))
    with pytest.raises(ValueError, match="contiguous"):
        adam_update(params, grads, state, lr=LR, out=out)


def _problem(device):
    ds = e3sm_like_field(n=2000, seed=0)
    data = partition.partition_data(ds.x, ds.y, partition.make_grid(ds.x, 4, 4), device=device)
    cfg = psvgp.PSVGPConfig(svgp=svgp.SVGPConfig(num_inducing=5, input_dim=2, use_pallas=True),
                            delta=0.25, batch_size=16, learning_rate=LR, seed=0)
    return psvgp.build(cfg, data), psvgp.init(0, cfg, data), data


@pytest.mark.cuda
def test_cuda_eager_fit_is_bitwise_the_plain_formulas(cuda_device, monkeypatch):
    """2,500 eager steps on the card, the Adam kernel's against the plain
    formula's in its place: the bias corrections at every t the
    benchmark's fits reach, through the whole step."""
    static, state, data = _problem(cuda_device)
    before = adam_kernel.LAUNCHES["adam_update"]
    got = psvgp.fit(static, state, data, 2500)
    assert adam_kernel.LAUNCHES["adam_update"] == before + 2500
    monkeypatch.setattr(psvgp, "adam_update", plain_adam_update)
    want = psvgp.fit(static, state, data, 2500)
    assert adam_kernel.LAUNCHES["adam_update"] == before + 2500
    fa, fb = flatten(got), flatten(want)
    assert [k for k in fa if not np.array_equal(fa[k], fb[k])] == []


class _CopyBackStep(psvgp.CapturedStep):
    """The captured step as it was before the kernel wrote its buffers:
    the new state out of place, then copied back leaf by leaf."""

    def _step(self) -> None:
        new, _loss = psvgp.train_step(self.static, psvgp.PSVGPState(*self.buffers), self.data,
                                      self.seed)
        for dst, src in zip(tree_leaves(self.buffers), tree_leaves(new), strict=True):
            dst.copy_(src)


def _device_ops(captured: psvgp.CapturedStep, replays: int) -> list[str]:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        captured.replay(replays)
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_cuda_replays_launch_adam_once_and_copy_no_state(cuda_device):
    static, state, data = _problem(cuda_device)
    warm = psvgp.fit(static, state, data, psvgp.WARMUP_STEPS, use_scan=True)
    captured = psvgp.CapturedStep(static, psvgp.device_counters(warm, cuda_device), data)
    assert captured.captured == {"svgp_projection": 1, "adam_update": 1, "minibatch_draws": 1}
    torch.cuda.synchronize()
    before = adam_kernel.LAUNCHES["adam_update"]
    torch.cuda.set_sync_debug_mode("warn")  # CUDA warns at every host synchronization
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            captured.replay(10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [w for w in caught if "synchroniz" in str(w.message).lower()] == []
    assert adam_kernel.LAUNCHES["adam_update"] == before + 10
    eager = psvgp.fit(static, warm, data, 10)
    got, want = flatten(captured.state()), flatten(eager)
    assert [k for k in got if not np.array_equal(got[k], want[k])] == []

    ops = _device_ops(captured, 10)
    old = _CopyBackStep(static, psvgp.device_counters(warm, cuda_device), data)
    old_ops = _device_ops(old, 10)
    assert ops and old_ops, "torch.profiler saw no device activity"
    assert sum("adam_update_kernel" in n for n in ops) == 10
    assert sum("adam_update_kernel" in n for n in old_ops) == 10
    # the copy-back's one copy a leaf: params, both moments, both counters
    assert len(old_ops) - len(ops) == 10 * len(tree_leaves(captured.buffers)) == 200
