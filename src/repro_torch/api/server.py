"""``Server`` — one front door for serving a fitted PSVGP.

    server = Server(fitted, ServeConfig(mode="sharded", pipeline="pipelined"))
    mean, var = server.submit(queries)           # one batch, blocking
    report = server.stream(batches)              # a request stream + SLO report
    server.swap(new_fitted, version=t)           # zero-downtime model update

or, straight from an artifact either package saved:

    server = Server.from_artifact("runs/e3sm_t42/", ServeConfig(mode="sharded"))

The config dispatches to the port's primitives exactly as the JAX
package's ``repro.api.Server`` does: ``blend.predict_blended`` for the
replicated lane; ``serve_sharded.make_halo_blend`` +
``make_request_stages`` + the serial/pipelined loops for the halo lane,
with the router (``StreamingQMax`` / ``TwoLevelQMax`` / fixed q_max) and
the kernel lane chosen by the config. Without a process group the
"sharded" program runs every cell locally: one slots-kernel launch per
request. With ``group=`` (a ``torch.distributed`` group of gx * gy ranks)
it is the MESH lane, one cell per rank, as the JAX package's mesh is one
partition per device: every rank builds a ``Server`` with the same model
and config, submits the same batches in the same order, and gets the
whole answer (``serve_sharded.make_mesh_request_stages``). The lane is
chosen by that argument alone.

Hot swap (the in-situ lifecycle): each model the server has gone live
with is an immutable ``_ServingContext`` — the fitted model, its cache
and its route/submit/collect stages, bound together once at build time.
``swap(new_fitted)`` builds the ENTIRE new context (cache factorized on
the device, halo program built, optionally warmed) while the old one
keeps serving, waits for the device to finish that work, and goes live
with one reference flip of ``_active`` under ``_swap_lock``. The stage
triple ``request_stages`` hands out never captures a context: its route
stage snapshots ``_active`` exactly once per request and threads that
context through submit and collect, so a request is answered wholly by
the model that was active when it was routed. The streaming q_max policy
is shared across contexts (q_max is traffic state, not model state).
A swapped-in model must keep the grid side in sharded mode, as in the
JAX package (whose mesh is one partition per device); its grid edges may
move with the data. On the mesh lane every rank swaps, in the same order.
"""
from __future__ import annotations

import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.api.config import ServeConfig
from repro_torch.api.fitted import FittedPSVGP
from repro_torch.core import routing
from repro_torch.launch import serve_sharded as ss


class _ServingContext:
    """One serving generation: a fitted model bound to its request stages.
    Immutable after ``Server._build_context`` returns (``requests``, the
    per-version served count for ``Server.lifecycle``, is the one mutable
    field)."""

    __slots__ = (
        "fitted", "version", "route", "submit", "collect",
        "cache_bytes", "requests", "build_seconds",
    )

    def __init__(self, fitted: FittedPSVGP, version):
        self.fitted = fitted
        self.version = version
        self.route: Callable | None = None
        self.submit: Callable | None = None
        self.collect: Callable | None = None
        self.cache_bytes: tuple[int, int] | None = None
        self.requests = 0
        self.build_seconds: float | None = None


class Server:
    """Serve a :class:`FittedPSVGP` the way a :class:`ServeConfig` says to.

    Attributes:
      fitted / config: the ACTIVE model (changes on :meth:`swap`) and the
        session config.
      device: where the models and the device program live (the first
        model's device unless ``device=`` moves it; swapped-in models are
        moved here).
      backend: the RESOLVED kernel lane ("ref" | "pallas" | "fused").
      policy: the streaming q_max policy (None in replicated mode and in
        the fixed-q_max lane), shared across swapped model versions.
      mesh: the mesh lane's ``serve_sharded.HaloMesh`` (None without a
        group).
      cache_bytes: sharded mode only — the active context's (total,
        per-device) cache memory; per rank on the mesh lane, total / P.
    """

    def __init__(self, fitted: FittedPSVGP, config: ServeConfig | None = None, device=None,
                 group=None):
        self.config = ServeConfig() if config is None else config
        if group is not None and self.config.mode != "sharded":
            raise ValueError(
                "group= builds the mesh lane of mode='sharded'; replicated "
                "serving holds every cell in one process"
            )
        fitted = fitted if device is None else fitted.to(device)
        self._mesh = None if group is None else ss.mesh_for_grid(fitted.grid, group)
        self.device = fitted.device
        self.backend = self.config.resolve_backend(self.device)
        self.policy = self.config.make_policy() if self.config.mode == "sharded" else None
        self._stats = {"requests": 0, "waste_rows": 0, "spilled": 0}
        # the route stages of the dispatch thread and a swap's warm probe
        # both count into _stats and the contexts' request counts
        self._stats_lock = threading.Lock()
        # _active is written under this lock and snapshotted exactly once
        # per request by the route trampoline
        self._swap_lock = threading.Lock()
        self._swaps = 0
        self._retired: list[_ServingContext] = []
        self._active = self._build_context(fitted, version=0)

    @classmethod
    def from_artifact(
        cls, path: str, config: ServeConfig | None = None, *, step: int | None = None,
        device=None,
    ) -> "Server":
        """``FittedPSVGP.load`` + ``Server`` in one step (``"cuda"`` unless
        ``device`` says otherwise)."""
        return cls(FittedPSVGP.load(path, step=step, device=device), config)

    @property
    def fitted(self) -> FittedPSVGP:
        """The model currently live — the active context's."""
        return self._active.fitted

    @property
    def mesh(self) -> ss.HaloMesh | None:
        """The mesh lane's ranks (None on the one-process program and in
        replicated mode)."""
        return self._mesh

    @property
    def cache_bytes(self) -> tuple[int, int] | None:
        return self._active.cache_bytes

    def _build_context(self, fitted: FittedPSVGP, version) -> _ServingContext:
        """Build one COMPLETE serving generation off the request path:
        factorize the cache on the device, build the halo program, wire
        the stage triple. Nothing here touches ``_active``."""
        t0 = time.perf_counter()
        ctx = _ServingContext(fitted, version)
        if self._mesh is not None:
            self._build_mesh_stages(ctx)
        elif self.config.mode == "sharded":
            self._build_sharded_stages(ctx)
        else:
            self._build_replicated_stages(ctx)
        if self.device.type == "cuda":
            # the counterpart of block_until_ready on the new cache: a
            # request sent after the flip must find it written
            torch.cuda.synchronize(self.device)
        ctx.build_seconds = time.perf_counter() - t0
        return ctx

    def _count(self, ctx: _ServingContext, table=None) -> None:
        with self._stats_lock:
            ctx.requests += 1
            self._stats["requests"] += 1
            if table is not None:
                self._stats["waste_rows"] += table.waste_rows()
                self._stats["spilled"] += table.num_spilled()

    def _wire_halo_stages(self, ctx: _ServingContext, stages) -> None:
        """Bind a halo lane's (route, submit, collect) to ``ctx``, counting
        every routed request."""
        route0, submit, collect = stages

        def route(q):
            table, blocks = route0(q)
            self._count(ctx, table)
            return table, blocks

        ctx.route, ctx.submit, ctx.collect = route, submit, collect

    def _build_sharded_stages(self, ctx: _ServingContext) -> None:
        fitted, grid = ctx.fitted, ctx.fitted.grid
        cache = fitted.cache
        ctx.cache_bytes = ss.cache_memory_bytes(cache)
        blend_fn = ss.make_halo_blend(grid, fitted.cov_fn, self.backend, self.device)
        self._wire_halo_stages(ctx, ss.make_request_stages(
            grid, blend_fn, cache,
            device=self.device,
            policy=self.policy,
            q_max=self.config.q_max,
            pad_multiple=self.config.pad_multiple,
        ))

    def _build_mesh_stages(self, ctx: _ServingContext) -> None:
        fitted, grid, mesh = ctx.fitted, ctx.fitted.grid, self._mesh
        local = ss.shard_cache(fitted.cache, mesh)
        ctx.cache_bytes = ss.cache_memory_bytes(fitted.cache, local)
        program = ss.make_sharded_blend(mesh, mesh.axis_names, grid, fitted.cov_fn,
                                        backend=self.backend)
        self._wire_halo_stages(ctx, ss.make_mesh_request_stages(
            grid, program, local, mesh,
            device=self.device,
            policy=self.policy,
            q_max=self.config.q_max,
            pad_multiple=self.config.pad_multiple,
        ))

    def _build_replicated_stages(self, ctx: _ServingContext) -> None:
        fitted = ctx.fitted
        # the cache is factorized here, up front, off the request path
        route, submit0, collect = ss.make_replicated_stages(
            fitted.cache, fitted.cov_fn, fitted.grid)

        def submit(pts):
            self._count(ctx)
            return submit0(pts)

        ctx.route, ctx.submit, ctx.collect = route, submit, collect

    # -- lifecycle ---------------------------------------------------------

    def swap(self, new_fitted: FittedPSVGP, *, version=None, warm: bool = True) -> dict:
        """Go live with ``new_fitted`` with zero downtime.

        The new context is fully built first (cache factorized, halo
        program built, the device synchronized, optionally one tiny probe
        served) while the current model keeps answering every request.
        Going live is then one reference flip under ``_swap_lock``:
        requests routed before the flip are answered by the old model end
        to end, requests routed after it by the new one.

        Args:
          new_fitted: the replacement model, e.g. from ``api.refit`` or
            ``FittedPSVGP.load(store, step=...)``; moved to this server's
            device. Sharded mode requires the active model's grid side.
          version: a label for the lifecycle report; defaults to the swap
            ordinal.
          warm: serve one tiny probe through the new context before the
            flip (not counted as served traffic).

        Returns ``{"version", "build_s", "swaps"}``.
        """
        old = self._active
        if self.config.mode == "sharded":
            og, ng = old.fitted.grid, new_fitted.grid
            if (og.gx, og.gy) != (ng.gx, ng.gy):
                raise ValueError(
                    f"cannot swap a {ng.gx}x{ng.gy} model into a "
                    f"{og.gx}x{og.gy} mesh — the halo program is built for "
                    "one grid; refit with the same grid side"
                )
        if version is None:
            version = self._swaps + 1
        ctx = self._build_context(new_fitted.to(self.device), version)
        if warm:
            g = ctx.fitted.grid
            probe = np.array(
                [[np.mean(g.x_edges[[0, -1]]), np.mean(g.y_edges[[0, -1]])]],
                np.float32,
            )
            ctx.collect(ctx.submit(ctx.route(probe)))
            ctx.requests = 0  # the warm probe is not served traffic
        with self._swap_lock:
            self._retired.append(old)
            self._active = ctx
            self._swaps += 1
        return {
            "version": ctx.version,
            "build_s": ctx.build_seconds,
            "swaps": self._swaps,
        }

    def lifecycle(self) -> dict:
        """The lifecycle section of the SLO report: swap count, the active
        version, and per version the requests served, the refit
        wall-clock (``FittedPSVGP.refit_seconds``) and the context build
        time (the work a swap did off the request path)."""
        versions = [
            {
                "version": c.version,
                "requests": c.requests,
                "refit_s": c.fitted.refit_seconds,
                "build_s": c.build_seconds,
            }
            for c in (*self._retired, self._active)
        ]
        return {
            "swaps": self._swaps,
            "active_version": self._active.version,
            "versions": versions,
        }

    # -- serving -----------------------------------------------------------

    def submit(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Answer one query batch (N, 2), blocking: (mean (N,), var (N,))."""
        ctx = self._active
        return ctx.collect(ctx.submit(ctx.route(queries)))

    def submit_many(self, requests) -> list[tuple[np.ndarray, np.ndarray]]:
        """Answer many small independent requests as ONE device batch:
        coalesced (``routing.coalesce_requests``), served like
        :meth:`submit`, split back (``routing.demux_results``). Equal to
        calling :meth:`submit` on each request alone — bitwise on the
        halo lane, where every row's result depends on its own query only.
        """
        pts, sizes = routing.coalesce_requests(requests)
        mean, var = self.submit(pts)
        return routing.demux_results(sizes, mean, var)

    def request_stages(self) -> tuple[Callable, Callable, Callable]:
        """The (route, submit, collect) triple of this server's path: route
        is pure numpy, submit copies to the device and enqueues, collect
        is the only sync point (the replicated lane has the same shape).

        The triple survives :meth:`swap`: route snapshots the ACTIVE
        context once and threads it through submit and collect, so every
        request is answered end to end by the model that was live when it
        was routed."""

        def route(q):
            ctx = self._active  # the one snapshot per request
            return ctx, ctx.route(q)

        def submit(routed):
            ctx, r = routed
            return ctx, ctx.submit(r)

        def collect(pending):
            ctx, p = pending
            return ctx.collect(p)

        return route, submit, collect

    def stream(self, batches, *, warm: bool = True, on_result: Callable | None = None) -> dict:
        """Serve a request stream through the configured loop; return the
        SLO report. Sharded + pipelined runs the overlapped loop; everything
        else the serial one. Results go to ``on_result(i, (mean, var))`` in
        stream order (bitwise the same between the two loops); a swap
        from ``on_result`` takes effect from the next request routed.

        Returns ``{"serve_config", "backend", "device", "latency_ms":
        {p50,p95,p99}, "points_per_s", "qmax_policy", "lifecycle"}``.
        """
        if self.config.mode == "sharded" and self.config.pipeline == "pipelined":
            route, submit, collect = self.request_stages()
            pct, qps = ss.pipelined_request_loop(
                route, submit, collect, batches, warm=warm, on_result=on_result,
            )
        else:
            if warm:
                self.submit(batches[0])
            if on_result is None:
                answer = self.submit
            else:
                idx = {"i": 0}

                def answer(q):
                    out = self.submit(q)
                    on_result(idx["i"], out)
                    idx["i"] += 1
                    return out

            pct, qps = ss.timed_request_loop(answer, batches, warm=False)
        if self.policy is not None:
            qmax = self.policy.stats()
        elif self.config.mode == "sharded":
            qmax = {"q_max": int(self.config.q_max), "fixed": True}
        else:
            qmax = None
        return {
            "serve_config": self.config.to_dict(),
            "backend": self.backend,
            "device": str(self.device),
            "latency_ms": pct,
            "points_per_s": qps,
            "qmax_policy": qmax,
            "lifecycle": self.lifecycle(),
        }

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Cumulative serving counters: requests routed, padded-row waste
        and spilled queries, plus the q_max policy record. They span model
        versions (``lifecycle()`` has the per-version split);
        :meth:`reset_stats` zeroes them. The mesh lane adds its exchange
        counters (``HaloMesh.stats``)."""
        with self._stats_lock:
            rec = dict(self._stats)
        if self.policy is not None:
            rec["qmax_policy"] = self.policy.stats()
        if self._mesh is not None:
            rec["mesh"] = self._mesh.stats()
        return rec

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._stats.update(requests=0, waste_rows=0, spilled=0)
        if self._mesh is not None:
            self._mesh.reset_stats()
