"""Async front door — continuous batching for many small independent queries
(PyTorch port of ``repro.api.frontdoor``).

The paper's in-situ setting serves many concurrent clients each asking
for a handful of points. This module is the in-process asyncio endpoint
for that traffic shape:

  * clients ``await FrontDoor.submit(points)`` with tiny (1..64-point)
    requests; each gets its own future;
  * an admission queue bounds the backlog (``FrontDoorConfig
    .queue_depth``): a request arriving at a full queue is DELAYED
    (backpressure) or SHED (``RequestRejected``) per
    ``FrontDoorConfig.admission``;
  * a batching window coalesces queued requests into ONE device batch
    (``routing.coalesce_requests``): dispatch triggers on ``max_rows``
    coalesced points or ``max_wait_ms`` after the window opened,
    whichever first;
  * the engine is double-buffered the way
    ``serve_sharded.pipelined_request_loop`` is: batch t+1 is gathered on
    the event loop and routed + dispatched (host route, H2D copy, kernel
    launch) in a dispatch thread while batch t's device-to-host copy
    blocks in a collect thread. Both threads enqueue their CUDA work on the
    device's default stream, so the copies and launches of a batch stay
    in order;
  * results come back per request via the routing ``src_idx`` inverse
    (``scatter_results`` inside ``Server.submit``) plus the ragged demux
    (``routing.demux_results``).

The golden property: however requests interleave, coalesce and demux,
every request's (mean, var) equals serving it alone through
``Server.submit`` — BITWISE over the halo ("sharded") lane, where every
row of the slots kernel and of the blend depends on its own query only.
"Recompiles" in the report keeps the JAX package's meaning — windows that
grew the streaming q_max policy's high-water mark (its ``compiles``
counter) — although nothing recompiles on the card.

Usage::

    server = api.Server(fitted, api.ServeConfig(mode="sharded"))
    async with api.FrontDoor(server, api.FrontDoorConfig(max_wait_ms=2)) as fd:
        mean, var = await fd.submit(points)        # (n, 2) with n <= 64
    report = fd.report()                           # SLO: latency, sheds, recompiles
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import threading
from typing import Any

import numpy as np

from repro_torch.api.config import FrontDoorConfig
from repro_torch.api.server import Server
from repro_torch.core import routing

_SENTINEL = object()  # queue wake-up marker posted by close()


class RequestRejected(RuntimeError):
    """Raised to a client whose request was shed by admission control
    (``FrontDoorConfig.admission == "shed"`` and the queue was full)."""


class RequestTooLarge(ValueError):
    """Raised at admission for a single request above
    ``FrontDoorConfig.max_request_rows``. A ``ValueError`` subclass (it
    IS a validation failure) but typed so transports can distinguish
    it — the HTTP layer maps it to 413, where a generic bad request is
    400. Rejecting at admission is load-bearing, not cosmetic: a
    request bigger than the batching window could otherwise wedge
    ``_gather_window`` (``rows < max_rows`` never admits a second
    request yet the window is already over budget) and push a single
    coalesced batch past the jit-stable block budget the q_max policy
    sized for."""


@dataclasses.dataclass
class _Request:
    """One admitted client request waiting in the batching queue."""

    points: np.ndarray  # (n, 2) float32, validated at admission
    n: int
    future: asyncio.Future
    t_arrival: float  # event-loop clock, set at admission


@dataclasses.dataclass
class _Batch:
    """One dispatched (in-flight) coalesced batch."""

    reqs: list[_Request]
    sizes: np.ndarray  # (R,) rows per request, coalesce order
    handle: Any  # whatever the submit stage returned (pending device work)


class FrontDoor:
    """The asyncio in-process endpoint wrapping an ``api.Server``.

    Construction does not touch the server; the engine task starts lazily
    on the first :meth:`submit` (or explicitly via ``async with``). All
    device interaction goes through the server's
    :meth:`~repro_torch.api.server.Server.request_stages` triple, so the same
    front door serves replicated and sharded, single and two-level
    router, any kernel backend.
    """

    def __init__(self, server: Server, config: FrontDoorConfig | None = None):
        self.server = server
        self.config = FrontDoorConfig() if config is None else config
        self._route, self._submit, self._collect = server.request_stages()
        self._queue: asyncio.Queue | None = None  # created on the running loop
        self._engine_task: asyncio.Task | None = None
        # collect blocks on device results — one worker thread keeps those
        # syncs (the device-to-host copies) off the event loop AND
        # serializes them: two concurrent blocking collects never happen
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frontdoor-collect"
        )
        # route + submit also leave the event loop: the host route and the
        # host-to-device copies must not stall admission. One worker
        # serializes dispatches so batches reach the device in window
        # order.
        self._dispatch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frontdoor-dispatch"
        )
        # guards the per-batch counters: written by the dispatch thread,
        # read by report() on the event loop
        self._stats_lock = threading.Lock()
        self._closing = False
        self._broken: BaseException | None = None  # engine crash, if any
        self._saw_sentinel = False  # close sentinel consumed mid-window
        # SLO counters
        self._arrived = 0
        self._admitted = 0
        self._completed = 0
        self._shed = 0
        self._delayed = 0
        self._recompiles = 0
        self._latency_s: list[float] = []
        self._batch_rows: list[int] = []
        self._batch_requests: list[int] = []

    # -- client side -------------------------------------------------------

    async def submit(self, points) -> tuple[np.ndarray, np.ndarray]:
        """Answer one small request: (n, 2) points with
        1 <= n <= ``max_request_rows`` -> (mean (n,), var (n,)).

        Validation failures raise ``ValueError`` immediately (a malformed
        request must never poison a coalesced batch). A full admission
        queue sheds (``RequestRejected``) or delays per the config.
        """
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"request must be (n, 2) points, got shape {pts.shape}")
        if pts.shape[0] < 1:
            raise ValueError(f"request must hold at least one point, got {pts.shape[0]}")
        if pts.shape[0] > self.config.max_request_rows:
            raise RequestTooLarge(
                f"request rows must be in [1, {self.config.max_request_rows}] "
                f"(FrontDoorConfig.max_request_rows), got {pts.shape[0]} — "
                "send bulk batches straight to Server.submit"
            )
        if self._closing:
            raise RuntimeError("front door is closed")
        if self._broken is not None:
            raise RuntimeError("front door engine failed") from self._broken
        self._ensure_started()
        loop = asyncio.get_running_loop()
        self._arrived += 1
        if self._queue.full():
            if self.config.admission == "shed":
                self._shed += 1
                raise RequestRejected(
                    f"admission queue full ({self.config.queue_depth} requests)"
                )
            self._delayed += 1  # backpressure: the put below blocks
        req = _Request(pts, int(pts.shape[0]), loop.create_future(), loop.time())
        await self._queue.put(req)
        self._admitted += 1
        return await req.future

    @property
    def broken(self) -> bool:
        """True once the engine has died — every subsequent submit raises.
        Read-only introspection for health endpoints (``repro_torch.net``)."""
        return self._broken is not None

    # -- lifecycle ---------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._engine_task is None:
            self._queue = asyncio.Queue(maxsize=self.config.queue_depth)
            self._engine_task = asyncio.get_running_loop().create_task(
                self._engine(), name="frontdoor-engine"
            )

    async def close(self) -> None:
        """Drain the queue, finish in-flight batches, stop the engine.
        Idempotent; the SLO report stays readable afterwards."""
        if self._closing:
            if self._engine_task is not None:
                await self._engine_task
            return
        self._closing = True
        if self._engine_task is not None:
            await self._queue.put(_SENTINEL)
            await self._engine_task
            # a submit that raced past the closing check into the dead
            # queue must fail loudly, not hang its client forever
            self._fail_requests(self._drain_now(), RuntimeError("front door closed"))
        self._pool.shutdown(wait=True)
        self._dispatch_pool.shutdown(wait=True)

    async def __aenter__(self) -> "FrontDoor":
        self._ensure_started()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- engine ------------------------------------------------------------

    async def _engine(self) -> None:
        """Double-buffered batching loop.

        Mirrors ``pipelined_request_loop``: batch t's blocking device
        sync runs CONCURRENTLY (a resolve task whose wait lives in the
        collect thread) while the engine gathers batch t+1 on the event
        loop and routes + dispatches it in the dispatch thread — so the
        window for batch t+1 FILLS during batch t's device time (that is
        what makes the batching continuous rather than stop-and-wait).
        The previous resolve is awaited before the next one starts: at
        most two batches in flight, results settled in dispatch order —
        and a lone batch resolves while the engine sleeps on an empty
        queue (the resolve must never wait for a NEXT window that may
        not come).

        If the engine itself dies (a routing/dispatch bug, a poisoned
        window), a hung client is worse than an error: every future the
        engine still owns — the window being dispatched plus everything
        queued — is rejected, and the door refuses new submits. The
        in-flight resolve settles its own futures (see ``_resolve``).
        """
        loop = asyncio.get_running_loop()
        pending: asyncio.Task | None = None
        draining = False
        reqs: list[_Request] = []
        try:
            while True:
                if draining:
                    reqs = self._drain_now()
                else:
                    gathered = await self._gather_window()
                    if gathered is None or self._saw_sentinel:
                        # close() posted the sentinel (between windows, or
                        # consumed mid-window): serve everything left
                        draining = True
                        reqs = (gathered or []) + self._drain_now()
                    else:
                        reqs = gathered
                if reqs:
                    batch = await loop.run_in_executor(
                        self._dispatch_pool, self._dispatch, reqs
                    )
                    reqs = []  # futures now owned by the batch's resolve
                    if pending is not None:
                        await pending
                    pending = loop.create_task(self._resolve(batch))
                elif draining:
                    if pending is not None:
                        await pending
                    if self._queue.empty():
                        return
        except Exception as err:
            self._broken = err
            self._fail_requests([*reqs, *self._drain_now()], err)
            if pending is not None:
                await pending  # the in-flight batch settles its own futures

    async def _gather_window(self) -> list[_Request] | None:
        """One batching window: blocks for the first request, then keeps
        coalescing until ``max_rows`` points are queued or ``max_wait_ms``
        elapsed since the window opened. Returns None on the close
        sentinel. The last admitted request may carry the window past
        max_rows by at most ``max_request_rows - 1`` points — requests
        are never split across batches."""
        item = await self._queue.get()
        if item is _SENTINEL:
            return None
        reqs, rows = [item], item.n
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.config.max_wait_ms / 1e3
        while rows < self.config.max_rows:
            timeout = deadline - loop.time()
            if timeout <= 0:
                break
            try:
                item = await asyncio.wait_for(self._queue.get(), timeout)
            except (TimeoutError, asyncio.TimeoutError):
                break
            if item is _SENTINEL:
                # serve what we have; the engine drains on the next turn
                self._saw_sentinel = True
                break
            reqs.append(item)
            rows += item.n
        return reqs

    def _fail_requests(
        self, reqs: list[_Request], err: BaseException
    ) -> None:
        """Reject every unresolved future in ``reqs`` — no client may be
        left awaiting a future nobody owns anymore."""
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(err)

    def _drain_now(self) -> list[_Request]:
        """Everything already queued, without waiting (close path)."""
        reqs = []
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if item is not _SENTINEL:
                reqs.append(item)
        return reqs

    def _policy_compiles(self) -> int:
        pol = self.server.policy
        return int(pol.compiles) if pol is not None else 0

    def _dispatch(self, reqs: list[_Request]) -> _Batch:
        """Coalesce + route + async-dispatch one window. Runs in the
        dispatch worker thread (the same work ``pipelined_request_loop``
        overlaps with the device) so host work never blocks the event
        loop; the per-batch counters it updates are read by ``report()``
        on the loop thread, hence the lock."""
        pts, sizes = routing.coalesce_requests([r.points for r in reqs])
        before = self._policy_compiles()
        handle = self._submit(self._route(pts))
        grew = self._policy_compiles() - before
        with self._stats_lock:
            if grew:  # this window burst the q_max high-water mark
                self._recompiles += grew
            self._batch_rows.append(int(sizes.sum()))
            self._batch_requests.append(len(reqs))
        return _Batch(reqs, sizes, handle)

    async def _resolve(self, batch: _Batch) -> None:
        """Block on batch's device results (collect thread), demux, and
        settle every request future. ANY failure between here and
        settlement — collect raising, a demux shape mismatch — must
        reject the whole batch rather than orphan its futures."""
        loop = asyncio.get_running_loop()
        try:
            mean, var = await loop.run_in_executor(
                self._pool, self._collect, batch.handle
            )
            outs = routing.demux_results(batch.sizes, mean, var)
        except Exception as err:
            self._fail_requests(batch.reqs, err)
            return
        now = loop.time()
        for req, out in zip(batch.reqs, outs, strict=True):
            if not req.future.done():
                req.future.set_result(out)
            self._latency_s.append(now - req.t_arrival)
        self._completed += len(batch.reqs)

    # -- SLO report --------------------------------------------------------

    def report(self) -> dict:
        """The front door's SLO record.

        Fields: ``requests`` (arrived / admitted / completed / shed /
        delayed), ``batches`` (count, rows and requests per coalesced
        batch), ``latency_ms`` (p50/p95/p99 END-TO-END per request:
        admission to future resolution, queueing included — unlike the
        per-batch service intervals of ``Server.stream``), ``recompiles``
        (windows that burst the streaming q_max high-water mark — the
        policy's ``compiles`` counter, the JAX package's recompiles),
        plus the
        policy stats, both configs, and the server's ``lifecycle``
        section (``Server.lifecycle``: swaps, active version, requests
        served and refit wall-clock per model version — the front door
        keeps admitting straight through a ``Server.swap``, and this is
        where that shows up).
        """
        with self._stats_lock:
            rows = np.asarray(self._batch_rows, np.int64)
            per = np.asarray(self._batch_requests, np.int64)
            recompiles = self._recompiles
        lat = np.sort(np.asarray(self._latency_s, np.float64)) * 1e3
        pct = (
            {
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
            }
            if lat.size
            else None
        )
        pol = self.server.policy
        return {
            "frontdoor_config": self.config.to_dict(),
            "serve_config": self.server.config.to_dict(),
            "requests": {
                "arrived": self._arrived,
                "admitted": self._admitted,
                "completed": self._completed,
                "shed": self._shed,
                "delayed": self._delayed,
            },
            "batches": {
                "count": int(rows.size),
                "rows_total": int(rows.sum()) if rows.size else 0,
                "rows_per_batch_mean": float(rows.mean()) if rows.size else 0.0,
                "rows_per_batch_max": int(rows.max()) if rows.size else 0,
                "requests_per_batch_mean": float(per.mean()) if per.size else 0.0,
            },
            "latency_ms": pct,
            "recompiles": recompiles,
            "qmax_policy": pol.stats() if pol is not None else None,
            "lifecycle": self.server.lifecycle(),
        }
