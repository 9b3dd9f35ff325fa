"""The mesh lane — one cell per rank of a ``torch.distributed`` group — on
the CPU over gloo, on 2x2 and 3x3 grids (the 3x3 grid's center cell has
all 8 neighbors on the grid).

Ranks are spawned processes (one thread each) that meet in a FileStore
under ``tmp_path``; every ``join`` has its own timeout. The mirrors of
``tests/test_serve_sharded.py``:

  * ``make_halo_gather`` resolves every slot as ``routing.halo_ids`` does,
    zeros off-grid, and ``routing.make_halo_stacker`` reproduces it;
  * the mesh lane (``Server(..., group=...)``) is BITWISE the one-process
    program (``make_halo_blend``) for both routers, serial and pipelined,
    on the ``auto`` (= ``ref`` here) and ``fused`` lanes, on a uniform and
    a zipf-skewed stream; pipelined == serial; every rank returns the same
    whole answer and ends the stream with the same q_max;
  * its answers are within ``ref.tolerance_ratio`` <= 1 (1e-5 of the
    blend's summed terms per row, ``blend.blend_error_scales``) of the JAX
    package's ``routing.predict_routed`` on a JAX-trained artifact,
    computed in this process, never in a rank;
  * per-rank ``cache_bytes`` is total / P, and a request costs 4 shifts;
    a rank's context keeps only its own cell of the factorized cache and
    holds the model in host memory; ``Server.fitted`` hands out the whole
    model on the server's device;
  * a group whose world size is not gx * gy raises, naming both numbers.

On the card (``cuda``-marked, skipped without a GPU): 4 ranks on one GPU,
the mesh lane bitwise the one-process program there, one slots-kernel
launch per rank a request.
"""
from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import pytest
import torch

JOIN_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(grid, seed: int = 1) -> list:
    """Two uniform requests and two zipf-skewed ones (a hot cell, so the
    two-level router spills)."""
    from repro_torch.data.spatial import zipf_query_stream

    rng = np.random.default_rng(seed)
    lo = [grid.x_edges[0], grid.y_edges[0]]
    hi = [grid.x_edges[-1], grid.y_edges[-1]]
    uniform = [rng.uniform(lo, hi, (n, 2)).astype(np.float32) for n in (200, 333)]
    return uniform + zipf_query_stream(grid, 300, 2, alpha=1.5, seed=seed + 1)


CONFIGS = [
    (router, pipeline, backend)
    for router in ("single", "two-level")
    for pipeline in ("serial", "pipelined")
    for backend in ("auto", "fused")
]


# ---------------------------------------------------------------------------
# the ranks (module level: spawned processes import them by name)
# ---------------------------------------------------------------------------


def _rank_gather(mesh, grid):
    from repro_torch.launch import serve_sharded as ss

    gather = ss.make_halo_gather(mesh, mesh.axis_names, grid)
    payload = torch.full((1, 1), float(mesh.rank + 1))  # rank + 1: 0 marks off-grid
    return {"halo": gather(payload)[0, :, 0].numpy(), "shifts": mesh.shifts}


def _rank_serve(device, artifact, other_artifact):
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.kernels import launches, predict

    fitted = api.FittedPSVGP.load(artifact, device=device)
    batches = _batches(fitted.grid)
    out = {"configs": {}}
    for router, pipeline, backend in CONFIGS:
        server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline=pipeline,
                                                    router=router, backend=backend),
                            group=dist.group.WORLD)
        res = []
        launches.reset()
        server.stream(batches, on_result=lambda i, r, res=res: res.append(r))
        out["configs"][(router, pipeline, backend)] = {
            "results": res,
            "qmax": server.policy.stats(),
            "mesh": server.stats()["mesh"],
            "launches": dict(predict.LAUNCHES),
        }
    out["cache_bytes"] = server.cache_bytes
    out["lane"] = (server.mesh.size, server.mesh.rank, server.mesh.cell)
    from repro_torch.core import posterior

    live = server.fitted
    out["resident"] = {
        "leading": sorted({t.shape[0] for t in posterior.cache_leaves(server._active.cache)}),
        "held_device": str(server._active.fitted.device),
        "live_device": str(live.device) == str(server.device),
        "live_cells": int(live.state.params.m_star.shape[0]),
    }
    del live
    try:
        api.Server(api.FittedPSVGP.load(other_artifact, device=device),
                   api.ServeConfig(mode="sharded"), group=dist.group.WORLD)
        out["wrong_world"] = None
    except ValueError as e:
        out["wrong_world"] = str(e)
    return out


def _rank_main(rank: int, world: int, store_path: str, job: str, out_dir: str,
               device: str, kwargs: dict) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from repro_torch.launch import serve_sharded as ss

        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            if job == "gather":
                from repro_torch.core.partition import PartitionGrid

                side = int(round(world ** 0.5))
                grid = PartitionGrid(side, side, np.arange(side + 1.0), np.arange(side + 1.0),
                                     False)
                result = _rank_gather(ss.mesh_for_grid(grid, dist.group.WORLD), grid)
            else:
                result = _rank_serve(device, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a rank reports its failure to the parent
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _spawn(tmp_path, world: int, job: str, device: str = "cpu", **kwargs) -> list:
    """Run ``job`` on ``world`` spawned ranks; return each rank's result."""
    import multiprocessing as mp

    out_dir = tmp_path / f"{job}_{world}"
    out_dir.mkdir()
    store = str(out_dir / "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, job, str(out_dir), device, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not alive, f"ranks {alive} still running after {JOIN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [2, 3])
def test_halo_gather_resolves_every_slot_as_halo_ids(tmp_path, side):
    from repro_torch.core import routing
    from repro_torch.core.partition import PartitionGrid

    grid = PartitionGrid(side, side, np.arange(side + 1.0), np.arange(side + 1.0), False)
    results = _spawn(tmp_path, side * side, "gather")
    halo = np.stack([r["halo"] for r in results])  # (P, 9)
    hids = routing.halo_ids(grid)
    for p in range(grid.num_partitions):
        ix, iy = grid.cell_of(p)
        for k, (dx, dy) in enumerate(routing.OFFSETS):
            on_grid = 0 <= ix + dx < grid.gx and 0 <= iy + dy < grid.gy
            want = float(hids[p, k] + 1) if on_grid else 0.0
            assert halo[p, k] == want, (p, k, halo[p, k], want)
    if side == 3:
        assert (halo[4] > 0).all()  # the center cell sees all 8 neighbors
    # the host-side stacker delivers what the exchange does
    pid = (np.arange(grid.num_partitions, dtype=np.float32) + 1)[:, None, None]
    np.testing.assert_array_equal(routing.make_halo_stacker(grid)(pid)[:, :, 0, 0], halo)
    # a diagonal slot is two hops: 4 straight + 4 x 2 diagonal
    assert all(r["shifts"] == 12 for r in results)


# ---------------------------------------------------------------------------
# serving: the mesh lane against the one-process program and against JAX
# ---------------------------------------------------------------------------


def _jax_artifact(path: str, side: int) -> str:
    from repro import api as japi
    from repro.data.spatial import e3sm_like_field

    fitted = japi.fit(japi.FitConfig(grid=side, m=5, train_iters=40, seed=0),
                      e3sm_like_field(n=1500, seed=0))
    fitted.save(path)
    return path


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_artifacts")
    return {side: _jax_artifact(str(root / f"grid{side}"), side) for side in (2, 3)}


@pytest.fixture(scope="module", params=[2, 3], ids=["2x2", "3x3"])
def mesh_run(request, artifacts, tmp_path_factory):
    """(side, the loaded port model on the CPU, every rank's results)."""
    from repro_torch import api

    side = request.param
    other = artifacts[5 - side]  # the other grid: a wrong world size
    results = _spawn(tmp_path_factory.mktemp(f"mesh{side}"), side * side, "serve",
                     artifact=artifacts[side], other_artifact=other)
    return side, api.FittedPSVGP.load(artifacts[side], device="cpu"), results


def _one_process(fitted, router, pipeline, backend) -> list:
    from repro_torch import api

    server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline=pipeline,
                                                router=router, backend=backend))
    out = []
    server.stream(_batches(fitted.grid), on_result=lambda i, r: out.append(r))
    return out


@pytest.mark.parametrize("router,pipeline,backend", CONFIGS)
def test_mesh_lane_is_bitwise_the_one_process_program(mesh_run, router, pipeline, backend):
    side, fitted, results = mesh_run
    want = _one_process(fitted, router, pipeline, backend)
    for rank, res in enumerate(results):
        got = res["configs"][(router, pipeline, backend)]["results"]
        assert len(got) == len(want) == 4
        for i, ((gm, gv), (wm, wv)) in enumerate(zip(got, want, strict=True)):
            assert np.array_equal(gm, wm) and np.array_equal(gv, wv), (side, rank, i)


def test_every_rank_answers_the_same_with_the_same_q_max(mesh_run):
    side, _, results = mesh_run
    assert [r["lane"] for r in results] == [
        (side * side, rank, (rank % side, rank // side)) for rank in range(side * side)
    ]
    for key in results[0]["configs"]:
        first = results[0]["configs"][key]
        for res in results[1:]:
            cfg = res["configs"][key]
            assert cfg["qmax"] == first["qmax"], key
            for (am, av), (bm, bv) in zip(cfg["results"], first["results"], strict=True):
                assert np.array_equal(am, bm) and np.array_equal(av, bv)
        if key[0] == "two-level":
            assert first["qmax"]["spilled"] > 0  # the skewed requests spilled


def test_pipelined_is_bitwise_serial_on_the_mesh(mesh_run):
    _, _, results = mesh_run
    for res in results:
        for router in ("single", "two-level"):
            for backend in ("auto", "fused"):
                serial = res["configs"][(router, "serial", backend)]["results"]
                piped = res["configs"][(router, "pipelined", backend)]["results"]
                for (am, av), (bm, bv) in zip(serial, piped, strict=True):
                    assert np.array_equal(am, bm) and np.array_equal(av, bv)


def test_mesh_lane_agrees_with_jax_predict_routed(mesh_run, artifacts):
    from repro import api as japi
    from repro.core import routing as jrouting
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.kernels import ref

    side, fitted, results = mesh_run
    jf = japi.FittedPSVGP.load(artifacts[side])
    for i, q in enumerate(_batches(fitted.grid)):
        want = jrouting.predict_routed(jf.cache, jf.static.cov_fn, jf.grid,
                                       jrouting.build_routing_table(jf.grid, q))
        mean_s, var_s = blend_error_scales(fitted.cache, fitted.grid, q)
        for key, cfg in results[0]["configs"].items():
            got = cfg["results"][i]
            for g, w, s in zip(got, want, (mean_s, var_s), strict=True):
                # 1e-5 of the summed terms per row (ROADMAP: tolerances)
                assert ref.tolerance_ratio(torch.as_tensor(g), torch.as_tensor(np.asarray(w)),
                                           s) <= 1, (side, key, i)


def test_per_rank_cache_bytes_is_total_over_p_and_a_request_is_four_shifts(mesh_run):
    side, fitted, results = mesh_run
    from repro_torch.launch import serve_sharded as ss

    total, _ = ss.cache_memory_bytes(fitted.cache)
    for res in results:
        assert res["cache_bytes"] == (total, total // (side * side))
        for cfg in res["configs"].values():
            # the stream's warm-up and its 4 requests, 4 shifts each
            assert cfg["mesh"]["shifts"] == 4 * 5
            assert cfg["mesh"]["exchange_s"] > 0 and cfg["mesh"]["gather_s"] > 0


def test_a_rank_keeps_only_its_cell_and_serves_a_host_model(mesh_run):
    """The mesh rank's context holds its own cell (leading axis 1) of the
    P-batched factorization and frees the rest; the model it serves stays
    whole in host memory, and ``Server.fitted`` is the whole model on the
    server's device."""
    side, fitted, results = mesh_run
    for res in results:
        assert res["resident"] == {"leading": [1], "held_device": "cpu", "live_device": True,
                                   "live_cells": side * side}


def test_a_wrong_world_size_raises_naming_both_numbers(mesh_run):
    side, _, results = mesh_run
    other = 5 - side
    for res in results:
        msg = res["wrong_world"]
        assert msg is not None
        assert f"{other * other} partitions" in msg and f"{side * side} ranks" in msg


def test_a_group_needs_sharded_mode(artifacts):
    from repro_torch import api

    fitted = api.FittedPSVGP.load(artifacts[2], device="cpu")
    with pytest.raises(ValueError, match="mode='sharded'"):
        api.Server(fitted, api.ServeConfig(mode="replicated"), group=object())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh lane's ranks launch the CUDA slots kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_mesh_lane_is_bitwise_the_one_process_program(cuda_device, artifacts, tmp_path):
    from repro_torch import api
    from repro_torch.kernels import build

    build.library()  # built once here, loaded by every rank
    results = _spawn(tmp_path, 4, "serve", device="cuda", artifact=artifacts[2],
                     other_artifact=artifacts[3])
    fitted = api.FittedPSVGP.load(artifacts[2], device=cuda_device)
    for router, pipeline, backend in CONFIGS:
        want = _one_process(fitted, router, pipeline, backend)
        for res in results:
            cfg = res["configs"][(router, pipeline, backend)]
            for (gm, gv), (wm, wv) in zip(cfg["results"], want, strict=True):
                assert np.array_equal(gm, wm) and np.array_equal(gv, wv)
            # auto is the fused lane on CUDA: one slots launch a request
            assert cfg["launches"]["posterior_predict_slots"] == 5
    for res in results:
        # the rank's card keeps one cell; the live model is handed out there
        assert res["resident"] == {"leading": [1], "held_device": "cpu", "live_device": True,
                                   "live_cells": 4}
