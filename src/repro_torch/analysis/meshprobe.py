"""The mesh lane's probes: every job on spawned gloo ranks, in one spawn.

The ``hlo`` and ``costs`` passes drive the mesh program (one cell per
rank, ``serve_sharded.make_sharded_blend``) on every rank of a
``torch.distributed`` group. Importing torch costs each spawned process
seconds, so all of a run's mesh jobs share ONE spawn of
max(side^2) ranks (16 for the default probe and the cost points), and the
4- and 9-rank points run on ``dist.new_group`` subgroups of it. Results
are kept for the life of the process (:data:`_MEMO`): they are functions
of the job and the device alone, so the passes of one CLI run, and
repeated runs in one process, share them.

A job is ``(program, backend, grid side, q_max, n_queries, m)``, as
``hlo.probe_job`` makes it; its result is the list of every rank's
``hlo.drive_program`` record, rank order. :func:`measure` also takes a
``variant`` beside each job, the name of an injected fault for tests: the
ranks call ``inject(variant)`` (a module-level function, so spawn can
pickle it) as a context manager around that job.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

JOIN_TIMEOUT_S = 600
COLLECTIVE_TIMEOUT_S = 180

_MEMO: dict = {}


def _rank_main(rank: int, world: int, store: str, jobs: list, out_dir: str, device: str,
               inject) -> None:
    import torch

    torch.set_num_threads(1)
    results: dict = {}
    try:
        import torch.distributed as dist

        from repro_torch.analysis import hlo

        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            if device.startswith("cuda"):
                torch.cuda.set_device(0)
            sizes = sorted({job[2] * job[2] for job, _ in jobs})
            # every rank joins every subgroup's creation, in one order
            groups = {n: dist.group.WORLD if n == world else dist.new_group(list(range(n)))
                      for n in sizes}
            for job, variant in jobs:
                program, backend, side, q_max, n_queries, m = job
                if rank >= side * side:
                    continue
                ctx = inject(variant) if variant is not None else contextlib.nullcontext()
                with ctx:
                    results[(job, variant)] = hlo.drive_program(
                        program, backend, grid_side=side, m=m, q_max=q_max,
                        n_queries=n_queries, device=device, group=groups[side * side])
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a rank reports its failure to the parent
        results = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def spawn(pairs: list, device: str, *, inject=None) -> dict:
    """Run ``pairs`` (a list of (job, variant)) on one spawn of ranks.
    Returns {(job, variant): [rank 0's result, rank 1's, ...]}."""
    import multiprocessing as mp

    world = max(job[2] * job[2] for job, _ in pairs)
    if device.startswith("cuda"):
        # build the kernels once, here, before the ranks load them
        from repro_torch.kernels import build

        build.library()
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="repro_torch_meshprobe_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"), pairs, tmp, device,
                                   inject))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, t0 + JOIN_TIMEOUT_S - time.monotonic()))
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            if alive:
                raise RuntimeError(f"mesh probe ranks {alive} still running after "
                                   f"{JOIN_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        per_rank = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"mesh probe rank {r} exited {p.exitcode} without a result")
            with open(path, "rb") as f:
                res = pickle.load(f)
            if "error" in res:
                raise RuntimeError(f"mesh probe rank {r} failed:\n{res['error']}")
            per_rank.append(res)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    SPAWNS.append({"ranks": world, "jobs": len(pairs),
                   "seconds": round(time.monotonic() - t0, 3)})
    return {pair: [per_rank[r][pair] for r in range(pair[0][2] * pair[0][2])]
            for pair in pairs}


SPAWNS: list = []  # ranks, jobs and wall seconds of every spawn this process made


def measure(pairs: list, device: str, *, inject=None) -> dict:
    """(job, variant) -> every rank's result, spawning once for the pairs
    not yet measured on ``device`` in this process."""
    missing = [p for p in dict.fromkeys(pairs) if (*p, device) not in _MEMO]
    if missing:
        _MEMO.update({(*p, device): res for p, res in spawn(missing, device,
                                                            inject=inject).items()})
    return {p: _MEMO[(*p, device)] for p in pairs}


def results(jobs: list, device: str) -> dict:
    """job -> every rank's result (no injected fault). The CLI calls it
    first with the union of its passes' mesh jobs: one spawn for all."""
    return {job: res for (job, _), res in measure([(j, None) for j in jobs], device).items()}
