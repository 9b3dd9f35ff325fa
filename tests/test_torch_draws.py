"""The gather step's draws and their CUDA kernel (``kernels/draws.py``,
``csrc/draws.cu``).

On the CPU: the kernel's plain version (``ref.minibatch_draws``, the
sampler's composition with a stable descending sort) against the
sampler's ``torch.topk`` draws (``sample_slots`` and
``sample_minibatch_indices``, the ranking of the ppermute and SPMD steps):
the same sources, the same mini-batches wherever no two valid scores tie
among a row's top B + 1, the same valid rows wherever no tie straddles the
batch's edge, and its own tie rule (the higher score first, then the lower
index), at the benchmark's (P, n_max) with short and empty cells and with
constructed ties; the CPU gather step drawing the twin's bits, ties
included (``ops.minibatch_draws``); the refusals of the wrapper and of
``ops.minibatch_draws``, and the wrapper's counter in the launch registry
(``kernels/launches.py``). On the card (``cuda``-marked, skipped without a GPU):
the kernel bitwise its plain version over 64 consecutive steps at both
shapes and past the fast body's row limit, and a captured launch drawing
its replay's step. No JAX here: the draws are the port's own.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import partition, psvgp, sampler, svgp
from repro_torch.core.neighbors import neighbor_table
from repro_torch.core.partition import PartitionGrid
from repro_torch.data.spatial import e3sm_like_field
from repro_torch.kernels import draws as draws_kernel
from repro_torch.kernels import launches, ops, ref
from repro_torch.optim import tree_leaves

SEED = 2**31 + 12345  # a seed past 32 bits, as the benchmark draws them
B = 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(g: int, n_max: int, seed: int = 0, delta: float = 0.125, device="cpu"):
    """A g x g grid's slot distribution and (P, n_max) storage: most cells
    hold n_max / 2 .. n_max points, a tenth hold fewer than B, two none;
    padded rows repeat the cell's first point with y 0 and mask 0, as
    ``partition_data`` pads."""
    rng = np.random.default_rng(seed)
    P = g * g
    counts = rng.integers(n_max // 2, n_max + 1, P)
    counts[0] = n_max
    short = rng.choice(np.arange(1, P), max(1, P // 10), replace=False)
    counts[short] = rng.integers(1, B, len(short))
    counts[short[:2]] = 0
    mask = (np.arange(n_max)[None] < counts[:, None]).astype(np.float32)
    x = rng.uniform(-1, 1, (P, n_max, 2)).astype(np.float32)
    x[mask == 0] = np.repeat(x[:, :1], n_max, 1)[mask == 0]
    y = (rng.normal(size=(P, n_max)) * mask).astype(np.float32)
    edges = np.linspace(0.0, 1.0, g + 1)
    tbl = torch.as_tensor(neighbor_table(PartitionGrid(g, g, edges, edges, False)))
    dist = sampler.slot_distribution(torch.as_tensor(counts, device=device), tbl.to(device),
                                     delta)
    return dist, *(torch.as_tensor(a, device=device) for a in (x, y, mask))


def _lane(draws, dist, mask, batch):
    """The sampler's ``torch.topk`` composition of the same draws (the
    ranking the ppermute and SPMD steps use)."""
    kprime, _slot = sampler.sample_slots(draws, dist)
    idx, _ = sampler.sample_minibatch_indices(draws, mask[kprime], batch)
    return kprime, idx


def _scores(seed, step, dist, mask, kprime):
    """Each row's scores as both lanes draw them (draw 1 of the step)."""
    draws = sampler.StepDraws(seed, step, mask.device)
    draws.uniform(tuple(dist.probs.shape))
    rows = mask[kprime]
    return draws.uniform(tuple(rows.shape)) + (rows - 1.0) * 1e9


def _compare(got, want, scores, mask, x, y, batch) -> int:
    """Assert what the twin and the topk lane share; return the rows whose
    top B + 1 valid scores tie (compared as row sets only)."""
    (kp, idx), (kp_w, idx_w) = got, want
    assert torch.equal(kp, kp_w)
    ranked = torch.sort(scores, dim=1, descending=True).values[:, :batch + 1]
    valid = ranked > -0.5e9
    tie = ((ranked[:, 1:] == ranked[:, :-1]) & valid[:, 1:]).any(1)
    edge = valid[:, batch] & (ranked[:, batch - 1] == ranked[:, batch])
    a = sampler.gather_minibatch(x, y, mask, kp, idx)
    b = sampler.gather_minibatch(x, y, mask, kp_w, idx_w)
    for u, v in zip(a, b, strict=True):
        assert torch.equal(u[~tie], v[~tie])
    src = mask[kp]
    for p in torch.nonzero(~edge)[:, 0].tolist():  # the same valid rows as sets
        mine = {i for i in idx[p].tolist() if src[p, i] == 1}
        assert mine == {i for i in idx_w[p].tolist() if src[p, i] == 1}
    return int(tie.sum())


@pytest.mark.parametrize("g, n_max", [(20, 224), (80, 240)], ids=["ne30", "ne120"])
def test_plain_twin_draws_the_lanes_sources_and_batches(g, n_max):
    dist, x, y, mask = _cells(g, n_max)
    counts = mask.sum(1)
    assert (counts == 0).sum() == 2 and ((counts > 0) & (counts < B)).any()
    ties = 0
    for step in (0, 1, 2499):
        got = ref.minibatch_draws(sampler.StepDraws(SEED, step, "cpu"), dist, mask, B)
        want = _lane(sampler.StepDraws(SEED, step, "cpu"), dist, mask, B)
        ties += _compare(got, want, _scores(SEED, step, dist, mask, got[0]), mask, x, y, B)
        # a short or empty source fills its batch with its padded rows, after its valid ones
        src = mask[got[0]]
        n = src.sum(1).long()
        taken = torch.gather(src, 1, got[1])
        assert torch.equal(taken, (torch.arange(B)[None] < n[:, None]).float())
    assert ties < 3 * len(dist.probs) // 1000 + 2  # 24-bit uniforms tie now and then


class _Given:
    """Draws whose uniforms are given, in the order the step asks for them."""

    def __init__(self, *uniforms):
        self.uniforms = list(uniforms)

    def uniform(self, shape, offset=0):
        u = self.uniforms.pop(0)
        assert tuple(u.shape) == tuple(shape) and offset == 0
        return u


def test_plain_twin_ranks_ties_by_index_and_keeps_the_lanes_rows():
    """Constructed ties: valid rows of equal score inside the batch, valid
    ties across its edge, and padded rows (all at -1e9) filling a short
    source's batch and an empty one's."""
    dist, x, y, mask = _cells(3, 12, seed=1, delta=0.0)
    P, n_max, batch = 9, 12, 5
    mask[:] = 1.0
    mask[1, 3:] = 0.0  # 3 points: the batch takes two padded rows
    mask[2] = 0.0  # empty: all padded
    x[1, 3:], y[1, 3:], x[2], y[2] = x[1, 0], 0.0, x[2, 0], 0.0
    slots = torch.full((P, 5), 0.5)
    slots[:, 0] = 0.999  # every cell draws itself (delta 0: the neighbours have p 0)
    rows = torch.rand((P, n_max), generator=torch.Generator().manual_seed(3)) * 0.5
    rows[0, [2, 7, 9]] = 0.75  # a tie inside the batch
    rows[3, [1, 4]] = 0.9
    rows[3, [0, 6, 8, 10, 11]] = 0.8  # the 3rd to 7th highest tie: the edge falls among them
    got = ref.minibatch_draws(_Given(slots, rows), dist, mask, batch)
    want = _lane(_Given(slots, rows.clone()), dist, mask, batch)
    assert torch.equal(got[0], torch.arange(P)) and torch.equal(got[0], want[0])
    assert got[1][0, :3].tolist() == [2, 7, 9]  # equal scores: the lower index first
    assert got[1][3].tolist() == [1, 4, 0, 6, 8]  # across the edge: the lowest indices
    assert got[1][1, :3].sort().values.tolist() == [0, 1, 2]
    assert set(got[1][1, 3:].tolist()) <= set(range(3, n_max))
    for p in (0, 1, 2, 4, 5, 6, 7, 8):  # no tie across the edge: the lane's valid rows
        src = mask[p]
        assert ({i for i in got[1][p].tolist() if src[i] == 1}
                == {i for i in want[1][p].tolist() if src[i] == 1})
    a = sampler.gather_minibatch(x, y, mask, *got)
    b = sampler.gather_minibatch(x, y, mask, *want)
    for u, v in zip(a, b, strict=True):  # padded rows are the same data whichever is taken
        assert torch.equal(u[[1, 2]], v[[1, 2]])


def test_wrapper_refuses_what_it_does_not_take():
    dist, _x, _y, mask = _cells(3, 40)
    with pytest.raises(ValueError, match="CUDA tensors"):
        draws_kernel.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, B, SEED, 0)
    with pytest.raises(ValueError, match="batch"):
        draws_kernel.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, 41, SEED, 0)
    with pytest.raises(ValueError, match="batch"):
        draws_kernel.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, 0, SEED, 0)
    assert draws_kernel.LAUNCHES == {"minibatch_draws": 0}


def test_ops_minibatch_draws_refuses_a_device_with_no_lane():
    dist, _x, _y, mask = _cells(3, 40)
    meta = sampler.SlotDistribution(*(t.to("meta") for t in dist))
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ops.minibatch_draws(meta, mask.to("meta"), B, SEED, 0)


def test_the_captured_step_counts_the_draws_kernel():
    """The wrapper's counter is the registry's ``minibatch_draws`` entry,
    which ``psvgp.CapturedStep`` counts and ``launches.reset`` zeroes."""
    launches.reset()
    draws_kernel.LAUNCHES["minibatch_draws"] += 3
    assert launches.counts()["minibatch_draws"] == 3
    launches.reset()
    assert draws_kernel.LAUNCHES == {"minibatch_draws": 0}


@pytest.mark.parametrize("counter", ["int", "tensor"])
def test_cpu_gather_step_draws_the_plain_twin_ties_included(monkeypatch, counter):
    """The CPU gather step's own draws are ``ref.minibatch_draws``'s bit
    for bit, where the uniforms are cut to quarters so that every row's
    top B holds ties, and its new state is the step's with the twin's
    draws injected."""
    ds = e3sm_like_field(n=400, seed=0)
    data = partition.partition_data(ds.x, ds.y, partition.make_grid(ds.x, 3, 3), device="cpu")
    cfg = psvgp.PSVGPConfig(svgp=svgp.SVGPConfig(num_inducing=4, input_dim=2), delta=0.25,
                            batch_size=8, learning_rate=0.05, seed=0)
    static, state = psvgp.build(cfg, data), psvgp.init(0, cfg, data)
    step = 5
    state = state._replace(step=step if counter == "int" else torch.tensor(step))
    uniform = sampler.StepDraws.uniform

    def quarters(self, shape, offset=0):
        return torch.floor(4 * uniform(self, shape, offset)) / 4

    monkeypatch.setattr(sampler.StepDraws, "uniform", quarters)
    seen = []
    gather = psvgp.gather_minibatch

    def recorder(x, y, mask, kprime, idx):
        seen.append((kprime, idx))
        return gather(x, y, mask, kprime, idx)

    monkeypatch.setattr(psvgp, "gather_minibatch", recorder)
    new, _loss = psvgp.train_step_gather(state, SEED, data.x, data.y, data.mask, static.dist,
                                         cfg, static.cov_fn)
    want = ref.minibatch_draws(sampler.StepDraws(SEED, step, "cpu"), static.dist, data.mask,
                               cfg.batch_size)
    (got,) = seen
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ranked = torch.sort(_scores(SEED, step, static.dist, data.mask, got[0]), dim=1,
                        descending=True).values[:, :cfg.batch_size]
    tie = (ranked[:, 1:] == ranked[:, :-1]) & (ranked[:, 1:] > -0.5e9)
    assert tie.any(1).all()  # a tie inside every row's top B
    injected, _ = psvgp.train_step_gather(state, SEED, data.x, data.y, data.mask, static.dist,
                                          cfg, static.cov_fn, draws=want)
    assert int(new.step) == int(injected.step) == step + 1
    for a, b in zip(*(tree_leaves((s.params, s.opt.mu, s.opt.nu)) for s in (new, injected)),
                    strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g, n_max, batch", [
    (20, 224, B), (80, 240, B), (4, 32, B), (5, 50, 7), (6, 100, B), (4, 400, 400),
    (5, 600, B), (3, 3000, B), (4, 700, 700),
], ids=["ne30", "ne120", "row-32", "row-50", "row-100", "kpl-16-whole-row", "long", "long-3000",
        "long-whole-row"])
def test_cuda_kernel_is_bitwise_its_plain_twin(cuda_device, g, n_max, batch):
    dist, _x, _y, mask = _cells(g, n_max, seed=g + n_max, device=cuda_device)
    counter = torch.zeros((), dtype=torch.int64, device=cuda_device)
    before = draws_kernel.LAUNCHES["minibatch_draws"]
    for step in range(64):
        counter.fill_(step)
        got = draws_kernel.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, batch, SEED,
                                           counter if step % 2 else step)
        want = ref.minibatch_draws(sampler.StepDraws(SEED, step, cuda_device), dist, mask, batch)
        assert torch.equal(got[0], want[0]), step
        assert torch.equal(got[1], want[1]), step
    assert draws_kernel.LAUNCHES["minibatch_draws"] == before + 64


@pytest.mark.cuda
def test_cuda_captured_launch_draws_its_replays_step(cuda_device):
    dist, _x, _y, mask = _cells(20, 224, device=cuda_device)
    step = torch.full((), 7, dtype=torch.int64, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # lazy initialization outside the capture
        draws_kernel.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, B, SEED, step)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kprime, idx = draws_kernel.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, B, SEED,
                                                   step)
        step.add_(1)
    for t in range(7, 12):
        graph.replay()
        want = ref.minibatch_draws(sampler.StepDraws(SEED, t, cuda_device), dist, mask, B)
        assert torch.equal(kprime, want[0]) and torch.equal(idx, want[1]), t
    assert int(step) == 12
