"""SPMD training — one cell per rank of a ``torch.distributed`` group — on
the CPU over gloo (``repro_torch.core.psvgp_spmd``), the mirror of
``tests/test_psvgp_spmd.py``.

Ranks are spawned processes (one thread each) that meet in a FileStore
under ``tmp_path``; every ``join`` has its own timeout. Checked:

  * a rank's row of a step's draw (``sampler.sample_row_indices`` with
    its row) is bitwise that row of the one-process (P, n_max) draw, with
    the counter as an int and as a device tensor;
  * the direction -> neighbor map (``psvgp_spmd.DIRECTION_OFFSETS``) is
    ``neighbors.direction_permutations``'s, and a receiver with no
    neighbor in direction d has importance weight 0;
  * on 2x2 and 3x3 grids, 5 SPMD steps are BITWISE the port's one-process
    ``train_step_ppermute``: every leaf of every rank's cell, both
    counters, and the batch every rank receives every step (zeros where
    the neighbor is off-grid, where the one-process step's placeholder is
    the receiver's own batch: both carry weight 0); the loss, summed over
    the ranks in another order, within rtol 1e-6; one hop a step where
    d != 0, none at d = 0;
  * the refusals: a grid that does not match the mesh, a wrapped grid, a
    group of the wrong world size;
  * against the JAX package: ``repro.core.psvgp_spmd.make_spmd_step`` on a
    2x2 host mesh (a subprocess with 4 XLA host devices, as
    ``tests/test_psvgp_spmd.py`` runs it), the port's ranks fed JAX's
    draws (d and each device's ``fold_in(kb, pid)`` row): one step within
    ``test_torch_train._assert_states_agree``'s defaults (params 1e-5),
    two steps within JAX's own atol 2e-4 on the params.

On the card (``cuda``-marked, skipped without a GPU): 4 ranks on one GPU
launch the projection kernel once a rank a step and receive bitwise the
one-process step's batches.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
import traceback

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120
STEPS = 5
SEED = 4  # its first 5 steps draw every direction: 3, 1, 0, 4, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(side: int, device: str = "cpu", n: int = 600):
    """(grid, data, static, initial state) of a small ppermute model: m 5,
    B 8, delta 0.5 (so that the steps move batches often)."""
    from repro_torch.core import partition, psvgp, svgp
    from repro_torch.data.spatial import e3sm_like_field

    ds = e3sm_like_field(n=n, seed=0)
    grid = partition.make_grid(ds.x, side, side)
    data = partition.partition_data(ds.x, ds.y, grid, device=device)
    cfg = psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(num_inducing=5, input_dim=2, use_pallas=device == "cuda"),
        delta=0.5, batch_size=8, learning_rate=0.05, comm="ppermute", seed=SEED,
    )
    static = psvgp.build(cfg, data)
    return grid, data, static, psvgp.init(0, cfg, data)


def _flat(state) -> dict:
    """A port state as ``{pytree-path: ndarray}`` (the checkpoint keys)."""
    from repro_torch.checkpoint.checkpoint import flatten

    out = flatten({"params": state.params, "opt": {"mu": state.opt.mu, "nu": state.opt.nu}})
    out["opt/step"] = np.asarray(int(state.opt.step))
    out["step"] = np.asarray(int(state.step))
    return out


# ---------------------------------------------------------------------------
# the ranks (module level: spawned processes import them by name)
# ---------------------------------------------------------------------------


def _rank_train(mesh, side: int, device: str) -> dict:
    """5 SPMD steps: 4 through the two halves (the received batches
    recorded), the last through the step's call."""
    import torch.distributed as dist

    from repro_torch.core import psvgp_spmd as spmd
    from repro_torch.core.partition import PartitionGrid
    from repro_torch.kernels import launches, svgp_proj
    from repro_torch.launch import serve_sharded as ss

    grid, data, static, state = _problem(side, device)
    step = spmd.make_spmd_step(mesh, mesh.axis_names, grid, static.cfg, static.cov_fn,
                               static.p_dir)
    x, y, mask, probs, n_eff = spmd.shard_data(
        (data.x, data.y, data.mask, static.dist.probs, static.dist.n_eff), mesh)
    state = spmd.shard_state(state, mesh)
    launches.reset()
    mesh.reset_stats()
    batches, losses = [], []
    for t in range(STEPS):
        if t < STEPS - 1:
            d, bx, by, bm = step.batch(state, SEED, x, y, mask)
            batches.append((int(d), *(a.cpu().numpy() for a in (bx, by, bm))))
            state, loss = step.update(state, d, bx, by, bm, probs, n_eff)
        else:
            state, loss = step(state, SEED, x, y, mask, probs, n_eff)
        losses.append(float(loss))
    out = {"batches": batches, "losses": losses, "own": _flat(state), "stats": mesh.stats(),
           "launches": dict(svgp_proj.LAUNCHES), "reduce_s": step.reduce_s}
    gathered = spmd.gather_state(state, mesh)
    if mesh.rank == 0:
        out["gathered"] = _flat(gathered)
    other = 5 - side
    try:
        ss.mesh_for_grid(PartitionGrid(other, other, np.arange(other + 1.0),
                                       np.arange(other + 1.0), False), dist.group.WORLD)
        out["wrong_world"] = None
    except ValueError as e:
        out["wrong_world"] = str(e)
    return out


def _rank_jax(mesh, npz: str) -> dict:
    """Two SPMD steps from the JAX package's state with its draws injected;
    the gathered state after each (rank 0)."""
    from repro_torch.core import psvgp, svgp
    from repro_torch.core import psvgp_spmd as spmd
    from repro_torch.core.partition import PartitionGrid
    from repro_torch.gp.covariances import rbf

    z = dict(np.load(npz))
    grid = PartitionGrid(2, 2, z["x_edges"], z["y_edges"], False)
    cfg = psvgp.PSVGPConfig(svgp=svgp.SVGPConfig(num_inducing=5, input_dim=2), delta=0.5,
                            batch_size=8, learning_rate=0.05, comm="ppermute")
    p_dir = torch.as_tensor(z["p_dir"])
    step = spmd.make_spmd_step(mesh, mesh.axis_names, grid, cfg, rbf, p_dir)
    arrays = spmd.shard_data(tuple(torch.as_tensor(z[k]) for k in
                                   ("x", "y", "mask", "probs", "n_eff")), mesh)
    state = psvgp.state_from_numpy({k[3:]: v for k, v in z.items() if k.startswith("s0/")}, "cpu")
    state = spmd.shard_state(state, mesh)
    out = {}
    for t in range(2):
        draws = (torch.as_tensor(z[f"d{t}"]), torch.as_tensor(z[f"idx{t}"][mesh.rank]))
        state, loss = step(state, 0, *arrays, draws=draws)
        gathered = spmd.gather_state(state, mesh)
        out[f"s{t + 1}"] = _flat(gathered)
        out[f"loss{t + 1}"] = float(loss)
    return out


def _rank_main(rank: int, world: int, store_path: str, job: str, out_dir: str,
               kwargs: dict) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from repro_torch.core.partition import PartitionGrid
        from repro_torch.launch import serve_sharded as ss

        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            side = int(round(world ** 0.5))
            mesh = ss.mesh_for_grid(PartitionGrid(side, side, np.arange(side + 1.0),
                                                  np.arange(side + 1.0), False),
                                    dist.group.WORLD)
            result = _rank_train(mesh, side, **kwargs) if job == "train" else _rank_jax(
                mesh, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a rank reports its failure to the parent
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _spawn(tmp_path, world: int, job: str, **kwargs) -> list:
    """Run ``job`` on ``world`` spawned ranks; return each rank's result."""
    import multiprocessing as mp

    out_dir = tmp_path / f"{job}_{world}"
    out_dir.mkdir()
    store = str(out_dir / "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, job, str(out_dir), kwargs))
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
# in process: the draws, the direction map, the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter", ["int", "tensor"])
def test_a_rows_draw_is_bitwise_that_row_of_the_one_process_draw(counter):
    from repro_torch.core import sampler

    _, data, static, _ = _problem(3)
    P, n_max = data.mask.shape
    for step in (0, 7, 1234):
        t = step if counter == "int" else torch.tensor(step)
        whole = sampler.StepDraws(SEED, t, "cpu")
        whole.uniform((5,))
        u = whole.uniform((P, n_max))
        one = sampler.StepDraws(SEED, t, "cpu")
        one.uniform((5,))
        idx_all, valid_all = sampler.sample_minibatch_indices(one, data.mask, 8)
        for p in range(P):
            row = sampler.StepDraws(SEED, t, "cpu")
            row.uniform((5,))
            assert torch.equal(row.uniform((1, n_max), offset=p * n_max)[0], u[p])
            row = sampler.StepDraws(SEED, t, "cpu")
            row.uniform((5,))
            idx, valid = sampler.sample_row_indices(row, data.mask[p], 8, row=p)
            assert torch.equal(idx, idx_all[p]) and torch.equal(valid, valid_all[p])
            # the batch, not only the indices (scores are 24-bit: rows can tie)
            assert torch.equal(data.x[p, idx], data.x[p, idx_all[p]])
            assert torch.equal(data.y[p, idx], data.y[p, idx_all[p]])


@pytest.mark.parametrize("gx,gy", [(2, 2), (3, 3), (4, 3)])
def test_direction_offsets_are_the_direction_permutations(gx, gy):
    from repro_torch.core import neighbors, partition, sampler
    from repro_torch.core.psvgp_spmd import DIRECTION_OFFSETS

    grid = partition.PartitionGrid(gx, gy, np.arange(gx + 1.0), np.arange(gy + 1.0), False)
    perms = neighbors.direction_permutations(grid)
    tbl = torch.as_tensor(neighbors.neighbor_table(grid))
    probs = sampler.slot_distribution(torch.full((gx * gy,), 10), tbl, 0.5).probs
    for p in range(grid.num_partitions):
        ix, iy = grid.cell_of(p)
        for d, (dx, dy) in enumerate(DIRECTION_OFFSETS):
            if 0 <= ix + dx < gx and 0 <= iy + dy < gy:
                assert perms[d][p] == grid.index_of(ix + dx, iy + dy)
            else:  # no neighbor: the one-process placeholder, weight 0
                assert perms[d][p] == p and float(probs[p, d]) == 0.0


def test_refusals_a_grid_off_the_mesh_and_a_wrapped_grid():
    from repro_torch.core import psvgp_spmd as spmd
    from repro_torch.core.partition import PartitionGrid

    _, _, static, _ = _problem(2)

    class Mesh:
        shape = {"data": 2, "model": 2}

    def build(grid):
        return spmd.make_spmd_step(Mesh(), ("data", "model"), grid, static.cfg, static.cov_fn,
                                   static.p_dir)

    with pytest.raises(ValueError, match="one partition per rank"):
        build(PartitionGrid(3, 2, np.arange(4.0), np.arange(3.0), False))
    with pytest.raises(NotImplementedError, match="wrapped"):
        build(PartitionGrid(2, 2, np.arange(3.0), np.arange(3.0), True))


# ---------------------------------------------------------------------------
# on the mesh: bitwise the one-process step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 3], ids=["2x2", "3x3"])
def spmd_run(request, tmp_path_factory):
    """(side, the one-process states/batches/losses, every rank's results)."""
    from repro_torch.core import psvgp

    side = request.param
    results = _spawn(tmp_path_factory.mktemp(f"spmd{side}"), side * side, "train",
                     device="cpu")
    _, data, static, state = _problem(side)
    batches, losses = [], []
    for _ in range(STEPS):
        b = psvgp.ppermute_batch(SEED, state.step, data.x, data.y, data.mask, static.perms,
                                 static.p_dir, static.cfg.batch_size)
        batches.append((int(b[0]), *(a.numpy() for a in b[1:])))
        state, loss = psvgp.train_step_ppermute(
            state, SEED, data.x, data.y, data.mask, static.dist, static.perms, static.p_dir,
            static.cfg, static.cov_fn)
        losses.append(float(loss))
    return side, {"state": _flat(state), "batches": batches, "losses": losses,
                  "perms": static.perms.numpy(), "probs": static.dist.probs.numpy()}, results


def test_spmd_state_is_bitwise_the_one_process_step(spmd_run):
    side, one, results = spmd_run
    want = one["state"]
    gathered = results[0]["gathered"]
    assert gathered.keys() == want.keys()
    for key, w in want.items():
        assert np.array_equal(gathered[key], w), key
    for p, res in enumerate(results):
        for key, w in want.items():
            row = w if key in ("step", "opt/step") else w[p:p + 1]
            assert np.array_equal(res["own"][key], row), (side, p, key)
    assert int(want["step"]) == int(want["opt/step"]) == STEPS


def test_received_batches_are_bitwise_the_one_process_batches(spmd_run):
    side, one, results = spmd_run
    moved = edges = 0
    for t, (d, bx, by, bm) in enumerate(one["batches"][:STEPS - 1]):
        for p, res in enumerate(results):
            got_d, gx, gy, gm = res["batches"][t]
            assert got_d == d, (t, p)
            if d != 0 and one["perms"][d][p] == p:
                # off-grid neighbor: zeros, where the one-process step puts
                # the receiver's own batch; both carry weight 0
                assert not gx.any() and not gy.any() and not gm.any(), (t, p)
                assert one["probs"][p, d] == 0.0
                edges += 1
            else:
                assert np.array_equal(gx[0], bx[p]), (t, p)
                assert np.array_equal(gy[0], by[p]) and np.array_equal(gm[0], bm[p]), (t, p)
                moved += d != 0
    assert moved and edges, "the steps never moved a batch or never reached an edge"


def test_loss_is_the_one_process_mean(spmd_run):
    _, one, results = spmd_run
    for res in results:
        np.testing.assert_allclose(res["losses"], one["losses"], rtol=1e-6)
        assert res["losses"] == results[0]["losses"]  # every rank the same mean


def test_one_hop_a_step_where_d_moves_none_at_self(spmd_run):
    _, one, results = spmd_run
    hops = sum(d != 0 for d, *_ in one["batches"])
    for res in results:
        assert res["stats"]["shifts"] == hops
        assert res["launches"] == {"svgp_projection": 0}  # the CPU lane: its plain version
        assert res["reduce_s"] > 0


def test_a_group_of_the_wrong_world_size_raises(spmd_run):
    side, _, results = spmd_run
    other = 5 - side
    for res in results:
        assert f"{other * other} partitions" in res["wrong_world"]
        assert f"{side * side} ranks" in res["wrong_world"]


# ---------------------------------------------------------------------------
# against the JAX package's make_spmd_step
# ---------------------------------------------------------------------------

_JAX_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import psvgp, sampler, svgp
    from repro.core.partition import make_grid, partition_data
    from repro.core.psvgp_spmd import make_spmd_step
    from repro.data.spatial import e3sm_like_field
    from repro.runtime import compat

    def flat(tree):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(
                str(e.key) if isinstance(e, jax.tree_util.DictKey)
                else (e.name if isinstance(e, jax.tree_util.GetAttrKey) else str(e.idx))
                for e in path)
            out[key] = np.asarray(leaf)
        return out

    ds = e3sm_like_field(n=400, seed=0)
    grid = make_grid(ds.x, gx=2, gy=2)
    data = partition_data(ds.x, ds.y, grid)
    cfg = psvgp.PSVGPConfig(svgp=svgp.SVGPConfig(num_inducing=5, input_dim=2), delta=0.5,
                            batch_size=8, learning_rate=0.05, comm="ppermute")
    static = psvgp.build(cfg, data)
    state = psvgp.init(jax.random.PRNGKey(0), cfg, data)
    state = psvgp.fit(static, state, data, 3)  # non-zero Adam moments
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    step = make_spmd_step(mesh, ("data", "model"), grid, cfg, static.cov_fn, static.p_dir)
    key = jax.random.PRNGKey(42)
    out = {"x": data.x, "y": data.y, "mask": data.mask, "probs": static.dist.probs,
           "n_eff": static.dist.n_eff, "p_dir": static.p_dir, "x_edges": grid.x_edges,
           "y_edges": grid.y_edges}
    out.update({"s0/" + k: v for k, v in flat(state).items()})
    for t in range(2):
        kd, kb = jax.random.split(jax.random.fold_in(key, state.step))
        out[f"d{t}"] = jax.random.categorical(kd, jnp.log(jnp.maximum(static.p_dir, 1e-30)))
        # device pid's row: sample_row_indices(fold_in(kb, pid), ...), as vmapped here
        out[f"idx{t}"] = sampler.sample_minibatch_indices(kb, data.mask, cfg.batch_size)[0]
        with compat.set_mesh(mesh):
            state, loss = step(state, key, data.x, data.y, data.mask, static.dist.probs,
                               static.dist.n_eff)
        out.update({f"s{t + 1}/" + k: v for k, v in flat(state).items()})
        out[f"loss{t + 1}"] = loss
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
    """
)


def _nested(flat: dict) -> dict:
    """``{"a/b": v}`` -> ``{"a": {"b": v}}`` (a pytree whose paths are the keys)."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def test_spmd_step_agrees_with_the_jax_spmd_step(tmp_path):
    from repro_torch.core import psvgp
    from test_torch_train import _assert_states_agree

    npz = str(tmp_path / "jax_spmd.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, npz], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    z = dict(np.load(npz))
    results = _spawn(tmp_path, 4, "jax", npz=npz)
    for t, atol in ((1, 1e-5), (2, 2e-4)):
        want = _nested({k[3:]: v for k, v in z.items() if k.startswith(f"s{t}/")})
        got = psvgp.state_from_numpy(results[0][f"s{t}"], "cpu")
        np.testing.assert_allclose(results[0][f"loss{t}"], z[f"loss{t}"], rtol=1e-5)
        if t == 1:
            _assert_states_agree(got, want)
        else:  # JAX's own bound for two steps (tests/test_psvgp_spmd.py)
            for key, w in results[0]["s2"].items():
                if key.startswith("params/"):
                    np.testing.assert_allclose(w, z[f"s2/{key}"], atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the SPMD ranks launch the CUDA projection kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_spmd_launches_once_a_step_and_receives_the_one_process_batches(cuda_device,
                                                                            tmp_path):
    from repro_torch.core import psvgp
    from repro_torch.kernels import build

    build.library()  # built once here, loaded by every rank
    results = _spawn(tmp_path, 4, "train", device="cuda")
    _, data, static, _ = _problem(2, "cuda")
    hops = 0
    for t in range(STEPS):
        d, bx, by, bm = psvgp.ppermute_batch(SEED, t, data.x, data.y, data.mask, static.perms,
                                             static.p_dir, static.cfg.batch_size)
        d = int(d)
        hops += d != 0
        if t == STEPS - 1:  # the last step ran through the call: no batch recorded
            continue
        for p, res in enumerate(results):
            got_d, gx, gy, gm = res["batches"][t]
            assert got_d == d
            if d == 0 or int(static.perms[d][p]) != p:
                assert np.array_equal(gx[0], bx[p].cpu().numpy())
                assert np.array_equal(gy[0], by[p].cpu().numpy())
                assert np.array_equal(gm[0], bm[p].cpu().numpy())
    for res in results:
        assert res["launches"] == {"svgp_projection": STEPS}
        assert res["stats"]["shifts"] == hops
