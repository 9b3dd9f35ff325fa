"""The port's dry-run (``repro_torch.launch.dryrun``) and its tracer, on the CPU.

The tracer runs the port's own steps on fake tensors, every leaf a
DTensor shard over a fake process group, and records one device's ops on
its local shards (``launch.hlo_analysis.Trace``). Held here:

  * ``collective_bytes`` on recorded collectives: the five kinds of the
    JAX package's ``test_collective_bytes_parser``, with its byte sums;
  * per-device FLOPs by hand: a sharded-by-sharded product counts one
    rank's local product, a replicated one the whole product;
  * the argument bytes of a small dense and a small MoE train step on a
    4x4 mesh equal the local shards of JAX's specs, leaf by leaf summed;
  * the period-extrapolated counts equal the full-depth trace's, exactly,
    at 2 and 3 periods (with a remainder layer);
  * ``reshard_for_heads`` hands a plain tensor back as it is, and
    replicates a head dim the mesh does not divide;
  * the PSVGP step at 4x4: rank 0's SPMD step moves one mini-batch by
    collective-permute (under 10 MB) and all-reduces its loss; the gather
    step all-gathers;
  * slow, as JAX's ``tests/test_dryrun.py``: the CLI on its four cases
    and on ``--psvgp``, as subprocesses.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import MeshSpec, make_production_mesh

MESH4 = MeshSpec(("data", "model"), (4, 4))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    """The tracer joins a fake process group; leave none behind."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_collective_bytes_on_recorded_ops():
    """The five kinds of the JAX package's parser test, recorded from real
    collectives over a fake group of 4 ranks (which moves no data)."""
    import torch.distributed as dist

    dryrun.fake_world(4)
    trace = hlo_analysis.Trace()
    with hlo_analysis.real_tracing(trace):
        dist.all_gather_into_tensor(torch.empty(128, 256), torch.ones(32, 256))
        dist.all_reduce(torch.ones(64, dtype=torch.bfloat16))
        dist.all_reduce(torch.ones(32, dtype=torch.bfloat16))
        recv = torch.empty(8)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.irecv, recv, 1),
                                            dist.P2POp(dist.isend, torch.ones(8), 2)]):
            work.wait()
        dist.all_to_all_single(torch.empty(16, 16), torch.ones(16, 16))
        dist.reduce_scatter_tensor(torch.empty(4096), torch.ones(4 * 4096))
        _ = torch.ones(2) + torch.ones(2)  # not a collective
    got = hlo_analysis.collective_bytes(trace)
    assert got == {"all-gather": 128 * 256 * 4, "all-reduce": (64 + 32) * 2,
                   "collective-permute": 8 * 4, "all-to-all": 16 * 16 * 4,
                   "reduce-scatter": 4096 * 4}
    assert hlo_analysis.collective_bytes(trace.collectives) == got
    assert set(got) == set(hlo_analysis.COLLECTIVE_KINDS)


def _dtensor(shape, placements, dmesh):
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import local_shape, to_placements

    return DTensor.from_local(torch.empty(local_shape(shape, placements, MESH4)), dmesh,
                              to_placements(placements, MESH4), run_check=False)


def test_per_device_flops_count_local_shards():
    from repro_torch.launch.mesh import device_mesh

    dryrun.fake_world(16)
    dmesh = device_mesh(MESH4)
    trace = hlo_analysis.Trace()
    with hlo_analysis.fake_tracing(trace):
        a = _dtensor((256, 64, 32), ("data", None, None), dmesh)
        b = _dtensor((32, 48), (None, "model"), dmesh)
        x = _dtensor((8, 16), (), dmesh)
        y = _dtensor((16, 4), (), dmesh)
        trace.suppress -= 1
        c = a @ b
        sharded = trace.flops
        z = x @ y
    assert tuple(c.to_local().shape) == (64, 64, 12)
    assert sharded == 2 * 64 * 64 * 32 * 12  # one rank's local product
    assert trace.flops - sharded == 2 * 8 * 16 * 4  # every rank computes the whole
    assert tuple(z.to_local().shape) == (8, 4)
    assert trace.collectives == []  # neither product moves data


@functools.cache
def _jax_local_state_bytes(arch: str) -> int:
    """Bytes of one device's params and Adam moments under JAX's specs on
    a 4x4 abstract mesh (the step counters left out: host ints in the
    port)."""
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro import sharding as jsh
    from repro.configs import registry as jreg
    from repro.runtime import steps as jsteps

    mesh = AbstractMesh(MESH4.sizes, MESH4.axis_names)
    state = jax.eval_shape(functools.partial(jsteps.init_train_state, cfg=jreg.get_smoke(arch)),
                           jax.random.PRNGKey(0))
    specs = jsh.state_pspecs(state, mesh)
    total = 0
    for leaves, spec_tree in ((state.params, specs.params), (state.opt.mu, specs.opt.mu),
                              (state.opt.nu, specs.opt.nu)):
        flat = jax.tree.leaves(leaves)
        flat_specs = jax.tree.leaves(spec_tree, is_leaf=lambda s: isinstance(s, PartitionSpec))
        for leaf, spec in zip(flat, flat_specs, strict=True):
            shape = list(leaf.shape)
            for i, entry in enumerate(spec):
                if entry is not None:
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    shape[i] //= math.prod(MESH4.shape[a] for a in axes)
            total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "deepseek_moe_16b"])
def test_train_arguments_are_the_local_shards_of_jax_specs(arch):
    cfg = get_smoke(arch)
    trace = dryrun.trace_combo(cfg, "train_4k", MESH4)
    B, S = 256, 4096
    batch = 2 * (B // 4) * S * 4  # tokens and targets, int32, batch over data
    assert trace.arguments == _jax_local_state_bytes(arch) + batch
    assert trace.flops > 0 and trace.bytes_accessed > 0
    assert trace.memory()["peak_est"] >= trace.arguments
    kinds = hlo_analysis.collective_bytes(trace)
    assert kinds.get("all-reduce", 0) > 0  # the tensor-parallel sums
    if arch == "deepseek_moe_16b":  # the expert-parallel layer's one all-reduce a layer
        assert any("models/moe.py" in site and kind == "all-reduce"
                   for kind, _, site in trace.collectives)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in hlo_analysis._tensors(tree))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_trace_equals_a_real_step_on_a_1x1_mesh(kind):
    """What chip_smoke.py holds on the card, at smoke size on the CPU: the
    trace's FLOPs equal ``FlopCounterMode`` on a real run of the same step,
    and its argument bytes the real inputs' bytes, exactly."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import InputShape
    from repro_torch.models import transformer
    from repro_torch.runtime.steps import init_train_state, make_decode_step, make_train_step

    cfg = dataclasses.replace(get_smoke("qwen3_0_6b"), dtype="bfloat16")
    B, S = 2, 32
    trace = dryrun.trace_combo(cfg, InputShape(S, B, kind), MeshSpec(("data", "model"), (1, 1)))
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((B, S if kind == "train" else 1), dtype=torch.int32)
    if kind == "train":
        args = (state, {"tokens": tokens, "targets": tokens.clone()})
        step = make_train_step(cfg)
    else:
        cache = transformer.init_cache(dataclasses.replace(cfg, remat=False), B, S,
                                       torch.bfloat16)
        args = (state.params, cache, torch.zeros((), dtype=torch.int64), tokens)
        step = make_decode_step(cfg)
    with FlopCounterMode(display=False) as counter:
        step(*args)
    assert trace.flops == counter.get_total_flops() > 0
    assert trace.arguments == _bytes(args)


@pytest.mark.parametrize("periods", [2, 3])
def test_period_extrapolation_equals_the_full_depth_trace(periods):
    """recurrentgemma's smoke pattern (rglru, rglru, local_attn) with one
    remainder layer: c1 + (n - 1)(c2 - c1) against the full-depth count."""
    cfg = get_smoke("recurrentgemma_2b")
    cfg = dataclasses.replace(cfg, num_layers=periods * cfg.period + 1)
    full, ex = (dryrun.dryrun_one("recurrentgemma_2b", "decode_32k", cfg_override=cfg,
                                  extrapolate=e, verbose=False) for e in (False, True))
    assert ex["flops_source"] == "trace+period-extrapolated" and full["flops_source"] == "trace"
    for key in ("flops_per_device", "hlo_bytes_per_device", "collective_breakdown",
                "bytes_per_device"):
        assert ex[key] == full[key], key


def test_reshard_for_heads():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.sharding.dtensor import reshard_for_heads

    x = torch.randn(2, 24)
    assert reshard_for_heads(x, 3) is x  # single-device paths: the same object
    dryrun.fake_world(16)
    dmesh = device_mesh(MESH4)
    trace = hlo_analysis.Trace()
    with hlo_analysis.fake_tracing(trace):
        d = _dtensor((8, 24), ("data", "model"), dmesh)
        trace.suppress -= 1
        assert reshard_for_heads(d, 8) is d  # 8 heads over 4: the reshape keeps its shard
        r = reshard_for_heads(d, 6)  # 6 heads over 4: the model axis gathers
    assert list(r.placements) == [Shard(0), Replicate()]
    assert [kind for kind, _, _ in trace.collectives] == ["all-gather"]


def test_psvgp_traces_at_4x4():
    from repro_torch.configs.psvgp_e3sm import DRYRUN_SINGLE_POD
    from repro_torch.core.partition import make_grid
    from repro_torch.core.psvgp_spmd import grid_matches_mesh

    exp = dataclasses.replace(DRYRUN_SINGLE_POD, grid=(4, 4))
    rank = dryrun.psvgp_rank_trace(MESH4, exp=exp)
    kinds = hlo_analysis.collective_bytes(rank)
    B, d = exp.batch_size, 2
    assert kinds == {"collective-permute": B * (d + 2) * 4, "all-reduce": 4}
    assert kinds["collective-permute"] < 10e6
    gather = dryrun.psvgp_gather_trace(MESH4, exp=exp)
    assert set(hlo_analysis.collective_bytes(gather)) == {"all-gather"}
    # the multi-pod grid's 32 rows are pod x data
    grid = make_grid(torch.zeros((1, 2)).numpy(), 16, 32, bounds=(0.0, 10.0, 0.0, 10.0))
    mesh = make_production_mesh(multi_pod=True)
    assert grid_matches_mesh(grid, mesh, mesh.axis_names)


# --------------------------------------------------------------------------
# the CLI, as JAX's slow tests run theirs
# --------------------------------------------------------------------------

_CASES = [
    ("qwen3_0_6b", "train_4k", []),
    ("recurrentgemma_2b", "long_500k", []),
    ("whisper_base", "decode_32k", []),
    ("deepseek_moe_16b", "prefill_32k", ["--multi-pod"]),
]


def _run(args, timeout=1200):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,extra", _CASES)
def test_dryrun_traces(arch, shape, extra, tmp_path):
    out = tmp_path / "rec.jsonl"
    r = _run(["--arch", arch, "--shape", shape, "--out", str(out), *extra])
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(out.read_text().strip().splitlines()[-1])
    assert rec["arch"] == arch and rec["shape"] == shape
    assert rec["flops_per_device"] > 0
    assert rec["roofline_s"]["memory"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    if extra:
        assert rec["chips"] == 512  # multi-pod: the pod axis actually shards
    assert rec["collective_bytes_per_device"] >= 0


@pytest.mark.slow
def test_dryrun_psvgp_contains_collective_permute(tmp_path):
    out = tmp_path / "psvgp.jsonl"
    r = _run(["--psvgp", "--comm", "ppermute", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(out.read_text().strip().splitlines()[-1])
    assert rec["chips"] == 256
    assert "collective-permute" in rec["collective_breakdown"]
    assert rec["collective_bytes_per_device"] < 10e6, rec["collective_breakdown"]
