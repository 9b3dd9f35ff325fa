"""The plain reference (``bench/reference/psvgp.py``) against the port's
eager step on the CPU, at a tiny size: the same storage, the same draws,
the same states to float32 rounding; and its TF32 control reads wrong."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from conftest import ROOT

from bench import compare, field
from bench.reference import psvgp as ref

CPU = torch.device("cpu")


def load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, "bench", kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def tiny(n=900, grid=(3, 3), seed=7):
    mix = load("traffic", "ne30_fit")
    mix.update(n_points=n, grid=list(grid))
    x, y = field.make(mix, seed, CPU)
    return mix, x, y


def program(cfg, mix, x, y, draw_seed):
    from repro_torch.core import partition, psvgp, svgp

    data = partition.partition_data(x, y, partition.make_grid(x, *mix["grid"]),
                                    pad_multiple=mix["pad_multiple"])
    pcfg = psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(num_inducing=cfg["num_inducing"], input_dim=2, use_pallas=True),
        delta=cfg["delta"], batch_size=cfg["batch_size"], learning_rate=cfg["learning_rate"],
        seed=draw_seed)
    return data, pcfg, psvgp.build(pcfg, data)


def test_partition_is_the_programs():
    from repro_torch.core import partition

    mix, x, y = tiny()
    data = partition.partition_data(x, y, partition.make_grid(x, 3, 3), pad_multiple=8)
    xs, ys, mask, counts = ref.partition(x, y, 3, 3, 8)
    assert np.array_equal(xs, data.x.numpy()) and np.array_equal(ys, data.y.numpy())
    assert np.array_equal(mask, data.mask.numpy())
    assert np.array_equal(counts, data.counts.numpy())


@pytest.mark.parametrize("step", [0, 1, 5, 2**40 + 3])
def test_draws_are_the_programs(step):
    from repro_torch.core import sampler

    cfg = load("configs", "psvgp_e3sm")
    mix, x, y = tiny()
    data, _, static = program(cfg, mix, x, y, 11)
    seed = 2**31 + 99
    draws = sampler.StepDraws(seed, step, CPU)
    kprime, _ = sampler.sample_slots(draws, static.dist)
    idx, _ = sampler.sample_minibatch_indices(draws, data.mask[kprime], 32)
    want = sampler.gather_minibatch(data.x, data.y, data.mask, kprime, idx)
    table = torch.as_tensor(ref.neighbours(3, 3))
    probs, n_eff = ref.slot_probs(data.counts.long(), table, cfg["delta"])
    assert torch.equal(probs, static.dist.probs) and torch.equal(n_eff, static.dist.n_eff)
    got = ref.minibatch(seed, step, probs, table, data.x, data.y, data.mask, 32)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config,cell", [("psvgp_e3sm", "psvgp_e3sm.ne30_fit"),
                                         ("psvgp_e3sm_m20", "psvgp_e3sm_m20.ne30_fit")])
def test_reference_follows_the_programs_eager_steps(config, cell):
    """The same initial state bit for bit; the first gradient and the
    change over 7 steps within the cell's limits."""
    from repro_torch.core import psvgp

    cfg = load("configs", config)
    limits = load("limits", cell)
    mix, x, y = tiny(seed=3)
    init_seed, draw_seed = 5, 2**33 + 1
    data, pcfg, static = program(cfg, mix, x, y, draw_seed)

    def leaves(p):
        return dict(zip(ref.LEAVES, (p.m_star, p.s_tril, p.z, p.cov.log_lengthscale,
                                     p.cov.log_variance, p.log_beta), strict=True))

    state = psvgp.init(init_seed, pcfg, data)
    p0 = {k: v.double() for k, v in leaves(state.params).items()}
    state = psvgp.fit(static, state, data, 1)
    grad1 = {k: v.double() / (1.0 - cfg["adam"]["b1"]) for k, v in leaves(state.opt.mu).items()}
    state = psvgp.fit(static, state, data, limits["steps"] - 1)
    p_end = {k: v.double() for k, v in leaves(state.params).items()}
    prog = {"grad1": grad1, "p0": p0, "p_end": p_end}
    follow = ref.follow(x, y, cfg, mix, init_seed, draw_seed, limits["steps"], CPU)
    for k in ref.LEAVES:
        assert torch.equal(follow["p0"][k], p0[k]), k
    read = compare.numbers(prog, follow)
    assert all(read[k] <= v for k, v in limits["limits"].items()), read


def test_tf32_control_reads_wrong_where_the_reference_reads_right():
    """At a CPU-sized field the control (the reference with every product's
    operands in TF32) fails one of the ne30 cell's numbers on every seed;
    the reference against itself reads 0."""
    cfg = load("configs", "psvgp_e3sm")
    limits = load("limits", "psvgp_e3sm.ne30_fit")["limits"]
    mix, x, y = tiny(n=3000, grid=(5, 5), seed=21)
    for seed in (1, 2, 3):
        sound = ref.follow(x, y, cfg, mix, seed, seed + 100, 7, CPU)
        control = ref.follow(x, y, cfg, mix, seed, seed + 100, 7, CPU, precision="tf32")
        assert max(compare.numbers(sound, sound).values()) == 0.0
        read = compare.numbers(control, sound)
        assert any(read[k] > limits[k] for k in limits), read


def test_to_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10 + 2**-12), 3.0])
    got = ref.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0]
