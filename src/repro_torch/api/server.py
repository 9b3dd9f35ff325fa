"""``Server`` — one front door for serving a loaded PSVGP on one device.

    server = Server(fitted, ServeConfig(mode="sharded", pipeline="pipelined"))
    mean, var = server.submit(queries)           # one batch, blocking
    report = server.stream(batches)              # a request stream + SLO report

or, straight from an artifact the JAX package saved:

    server = Server.from_artifact("runs/e3sm_t42/", ServeConfig(mode="sharded"))

The config dispatches to the port's primitives exactly as the JAX
package's ``repro.api.Server`` does: ``blend.predict_blended`` for the
replicated lane; ``serve_sharded.make_halo_blend`` +
``make_request_stages`` + the serial/pipelined loops for the halo lane,
with the router (``StreamingQMax`` / ``TwoLevelQMax`` / fixed q_max) and
the kernel lane chosen by the config. On one GPU the "sharded" program
runs every cell locally: one slots-kernel launch per request.
``swap`` (hot swap) comes with a later slice.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np

from repro_torch.api.config import ServeConfig
from repro_torch.api.fitted import FittedPSVGP
from repro_torch.core import routing
from repro_torch.launch import serve_sharded as ss


class Server:
    """Serve a :class:`FittedPSVGP` the way a :class:`ServeConfig` says to.

    Attributes:
      fitted / config: the served model (on ``device``) and the session config.
      device: where the model and the device program live (the fitted
        model's device unless ``device=`` moves it).
      backend: the RESOLVED kernel lane ("ref" | "pallas" | "fused").
      policy: the streaming q_max policy (None in replicated mode and in
        the fixed-q_max lane).
      cache_bytes: sharded mode only — (total, per-device) cache memory.
    """

    def __init__(self, fitted: FittedPSVGP, config: ServeConfig | None = None, device=None):
        self.config = ServeConfig() if config is None else config
        self.fitted = fitted if device is None else fitted.to(device)
        self.device = self.fitted.device
        self.backend = self.config.resolve_backend(self.device)
        self.policy = self.config.make_policy() if self.config.mode == "sharded" else None
        self.cache_bytes: tuple[int, int] | None = None
        self._stats = {"requests": 0, "waste_rows": 0, "spilled": 0}
        if self.config.mode == "sharded":
            self._route, self._submit, self._collect = self._sharded_stages()
        else:
            self._route, self._submit, self._collect = self._replicated_stages()

    @classmethod
    def from_artifact(
        cls, path: str, config: ServeConfig | None = None, *, step: int | None = None,
        device=None,
    ) -> "Server":
        """``FittedPSVGP.load`` + ``Server`` in one step (``"cuda"`` unless
        ``device`` says otherwise)."""
        return cls(FittedPSVGP.load(path, step=step, device=device), config)

    def _sharded_stages(self):
        fitted, grid = self.fitted, self.fitted.grid
        cache = fitted.cache
        self.cache_bytes = ss.cache_memory_bytes(cache)
        blend_fn = ss.make_halo_blend(grid, fitted.cov_fn, self.backend, self.device)
        route0, submit, collect = ss.make_request_stages(
            grid, blend_fn, cache,
            device=self.device,
            policy=self.policy,
            q_max=self.config.q_max,
            pad_multiple=self.config.pad_multiple,
        )

        def route(q):
            table, blocks = route0(q)
            self._stats["requests"] += 1
            self._stats["waste_rows"] += table.waste_rows()
            self._stats["spilled"] += table.num_spilled()
            return table, blocks

        return route, submit, collect

    def _replicated_stages(self):
        fitted = self.fitted
        _ = fitted.cache  # factorize up front, off the request path

        def route(q):
            return np.asarray(q, np.float32)

        def submit(pts):
            self._stats["requests"] += 1
            return fitted.predict(pts)

        def collect(pending):
            return pending[0].cpu().numpy(), pending[1].cpu().numpy()

        return route, submit, collect

    # -- serving -----------------------------------------------------------

    def request_stages(self) -> tuple[Callable, Callable, Callable]:
        """The (route, submit, collect) triple of this server's path: route
        is pure numpy, submit copies to the device and enqueues, collect
        is the only sync point (the replicated lane has the same shape)."""
        return self._route, self._submit, self._collect

    def submit(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Answer one query batch (N, 2), blocking: (mean (N,), var (N,))."""
        return self._collect(self._submit(self._route(queries)))

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

    def stream(self, batches, *, warm: bool = True, on_result: Callable | None = None) -> dict:
        """Serve a request stream through the configured loop; return the
        SLO report. Sharded + pipelined runs the overlapped loop; everything
        else the serial one. Results go to ``on_result(i, (mean, var))`` in
        stream order (bitwise the same between the two loops).

        Returns ``{"serve_config", "backend", "device", "latency_ms":
        {p50,p95,p99}, "points_per_s", "qmax_policy"}``.
        """
        if self.config.mode == "sharded" and self.config.pipeline == "pipelined":
            pct, qps = ss.pipelined_request_loop(
                self._route, self._submit, self._collect, batches,
                warm=warm, on_result=on_result,
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
        }

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Cumulative serving counters: requests routed, padded-row waste
        and spilled queries, plus the q_max policy record."""
        rec = dict(self._stats)
        if self.policy is not None:
            rec["qmax_policy"] = self.policy.stats()
        return rec
