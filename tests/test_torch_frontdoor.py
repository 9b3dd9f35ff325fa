"""The port's async front door (``repro_torch.api.frontdoor``) on the CPU
lane, mirroring the JAX package's tests/test_frontdoor.py.

The golden property — however concurrent requests interleave, coalesce
and demux, every answer equals serving that request alone through
``Server.submit`` — is held BITWISE on the halo ("sharded") lane, across
both routers. Also: coalescing into one batch, shed and delay admission,
the typed oversized error, validation and close, an engine crash that
rejects every queued future, and a collect failure that rejects its batch
while the engine survives. The CPU servers are prewarmed past any
window's q_max, as the JAX package's sharded swap test prewarms them: the
CPU lane's batched matmuls may round a row differently at another q_max.
The ``cuda`` twin holds the golden property on the card's kernel lane,
which needs no prewarm.
"""
from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import routing
from repro_torch.data.spatial import e3sm_like_field


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted():
    torch.set_num_threads(1)
    ds = e3sm_like_field(n=1000, seed=0)
    return api.fit(api.FitConfig(grid=3, m=4, train_iters=60, seed=0), ds, device="cpu")


def _bounds(fitted):
    g = fitted.grid
    return [g.x_edges[0], g.y_edges[0]], [g.x_edges[-1], g.y_edges[-1]]


def _prewarm(server) -> None:
    lo, hi = _bounds(server.fitted)
    server.submit(np.random.default_rng(99).uniform(lo, hi, (2048, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def server(fitted):
    srv = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined"))
    _prewarm(srv)
    return srv


def _requests(fitted, n_req, seed, max_rows=64):
    rng = np.random.default_rng(seed)
    lo, hi = _bounds(fitted)
    return [
        rng.uniform(lo, hi, (int(rng.integers(1, max_rows + 1)), 2)).astype(np.float32)
        for _ in range(n_req)
    ]


def _assert_bitwise(got, solo, tag=""):
    for i, ((mg, vg), (ms, vs)) in enumerate(zip(got, solo, strict=True)):
        assert np.array_equal(mg, ms) and np.array_equal(vg, vs), (tag, i)


@pytest.mark.parametrize("router", ["single", "two-level"])
def test_concurrent_clients_equal_solo_bitwise(fitted, router):
    """24 jittered async clients: every coalesced-then-demuxed answer is
    bitwise the solo ``Server.submit`` answer; the report accounts for
    every request."""
    server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined",
                                                router=router))
    _prewarm(server)
    reqs = _requests(fitted, 24, seed=1)
    jitter = np.random.default_rng(2).uniform(0, 0.004, len(reqs))

    async def client(fd, i):
        await asyncio.sleep(float(jitter[i]))
        return await fd.submit(reqs[i])

    async def main():
        async with api.FrontDoor(server, api.FrontDoorConfig(max_wait_ms=2.0,
                                                             max_rows=256)) as fd:
            got = await asyncio.gather(*(client(fd, i) for i in range(len(reqs))))
        return got, fd.report()

    got, rep = asyncio.run(main())
    _assert_bitwise(got, [server.submit(q) for q in reqs], router)
    r = rep["requests"]
    assert r["arrived"] == r["admitted"] == r["completed"] == len(reqs)
    assert r["shed"] == 0
    assert rep["batches"]["rows_total"] == sum(len(q) for q in reqs)
    assert rep["latency_ms"]["p95_ms"] > 0
    assert rep["recompiles"] == 0  # prewarmed: no window grew q_max
    assert rep["lifecycle"]["active_version"] == 0


def test_recompiles_count_the_windows_that_grew_q_max(fitted):
    """The report's ``recompiles`` is the q_max policy's ``compiles``
    counter over the stream (the JAX package's meaning), and the answers
    stay equal to solo submits through the growth."""
    server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined"))
    reqs = _requests(fitted, 10, seed=11)

    async def main():
        async with api.FrontDoor(server, api.FrontDoorConfig(max_wait_ms=3.0,
                                                             max_rows=256)) as fd:
            got = await asyncio.gather(*(fd.submit(q) for q in reqs))
        return got, fd.report()

    got, rep = asyncio.run(main())
    assert rep["recompiles"] >= 1
    assert rep["recompiles"] == rep["qmax_policy"]["compiles"]
    for (mg, vg), q in zip(got, reqs, strict=True):
        ms, vs = server.submit(q)
        np.testing.assert_allclose(mg, ms, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vg, vs, rtol=1e-5, atol=1e-5)


def test_submit_many_equal_solo_and_exact_demux(server, fitted):
    reqs = _requests(fitted, 7, seed=3)
    many = server.submit_many(reqs)
    _assert_bitwise(many, [server.submit(q) for q in reqs])
    pts, sizes = routing.coalesce_requests(reqs)
    mean, var = server.submit(pts)
    off = 0
    for (mg, vg), n in zip(many, sizes, strict=True):
        np.testing.assert_array_equal(mg, mean[off:off + n])
        np.testing.assert_array_equal(vg, var[off:off + n])
        off += int(n)


def test_requests_coalesce_into_one_batch(server, fitted):
    reqs = _requests(fitted, 6, seed=4, max_rows=8)

    async def main():
        async with api.FrontDoor(server, api.FrontDoorConfig(max_wait_ms=20.0,
                                                             max_rows=4096)) as fd:
            got = await asyncio.gather(*(fd.submit(q) for q in reqs))
        return got, fd.report()

    got, rep = asyncio.run(main())
    assert rep["batches"]["count"] == 1
    assert rep["batches"]["requests_per_batch_mean"] == 6.0
    _assert_bitwise(got, server.submit_many(reqs))


def test_shed_admission_rejects_over_capacity(server, fitted):
    async def main():
        fd = api.FrontDoor(server, api.FrontDoorConfig(queue_depth=1, admission="shed",
                                                       max_wait_ms=1.0))
        reqs = _requests(fitted, 8, seed=5, max_rows=4)
        got = await asyncio.gather(*(fd.submit(q) for q in reqs), return_exceptions=True)
        await fd.close()
        return got, fd.report()

    got, rep = asyncio.run(main())
    shed = [g for g in got if isinstance(g, api.RequestRejected)]
    served = [g for g in got if not isinstance(g, BaseException)]
    assert shed and served
    assert len(shed) + len(served) == 8
    r = rep["requests"]
    assert r["shed"] == len(shed) and r["completed"] == len(served)
    assert r["arrived"] == 8 and r["admitted"] == len(served)


def test_delay_admission_backpressures_and_serves_all(server, fitted):
    async def main():
        async with api.FrontDoor(server, api.FrontDoorConfig(queue_depth=1, admission="delay",
                                                             max_wait_ms=1.0)) as fd:
            reqs = _requests(fitted, 6, seed=6, max_rows=4)
            got = await asyncio.gather(*(fd.submit(q) for q in reqs))
        return got, reqs, fd.report()

    got, reqs, rep = asyncio.run(main())
    _assert_bitwise(got, [server.submit(q) for q in reqs])
    r = rep["requests"]
    assert r["completed"] == 6 and r["shed"] == 0
    assert r["delayed"] >= 1


def test_validation_and_lifecycle(server, fitted):
    lo, hi = _bounds(fitted)
    mid = np.array([[(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2]], np.float32)

    async def main():
        fd = api.FrontDoor(server, api.FrontDoorConfig(max_request_rows=8))
        with pytest.raises(ValueError, match=r"\(n, 2\)"):
            await fd.submit(np.zeros((3, 3), np.float32))
        with pytest.raises(ValueError, match="Server.submit"):
            await fd.submit(np.zeros((9, 2), np.float32))
        with pytest.raises(ValueError):
            await fd.submit(np.zeros((0, 2), np.float32))
        out = await fd.submit(mid)
        assert out[0].shape == (1,)
        await fd.close()
        await fd.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            await fd.submit(mid)
        assert fd.report()["requests"]["completed"] == 1

    asyncio.run(main())


def test_oversized_request_raises_typed_request_too_large(server):
    assert issubclass(api.RequestTooLarge, ValueError)

    async def main():
        fd = api.FrontDoor(server, api.FrontDoorConfig(max_request_rows=8))
        with pytest.raises(api.RequestTooLarge, match="Server.submit"):
            await fd.submit(np.zeros((9, 2), np.float32))
        with pytest.raises(ValueError) as exc:
            await fd.submit(np.zeros((0, 2), np.float32))
        assert not isinstance(exc.value, api.RequestTooLarge)
        assert not fd.broken
        await fd.close()

    asyncio.run(main())


def test_engine_crash_rejects_all_queued_futures(server, fitted):
    reqs = _requests(fitted, 10, seed=7, max_rows=4)
    lo, hi = _bounds(fitted)

    async def main():
        fd = api.FrontDoor(server, api.FrontDoorConfig(max_wait_ms=1.0, max_rows=8,
                                                       max_request_rows=4))
        real_submit = fd._submit
        calls = 0

        def boom(routed):
            nonlocal calls
            calls += 1
            if calls >= 2:  # batch 1 dispatches fine; batch 2 kills the engine
                raise RuntimeError("boom")
            return real_submit(routed)

        fd._submit = boom
        got = await asyncio.wait_for(
            asyncio.gather(*(fd.submit(q) for q in reqs), return_exceptions=True), timeout=30,
        )
        with pytest.raises(RuntimeError, match="engine failed"):
            await fd.submit(np.array([lo], np.float32))
        await fd.close()
        return got

    got = asyncio.run(main())
    served = [g for g in got if not isinstance(g, BaseException)]
    failed = [g for g in got if isinstance(g, BaseException)]
    assert len(served) + len(failed) == len(reqs)
    assert served and failed
    assert all(isinstance(g, RuntimeError) for g in failed), failed


def test_collect_failure_rejects_batch_but_engine_survives(server, fitted):
    lo, _ = _bounds(fitted)
    q = np.array([lo], np.float32)

    async def main():
        fd = api.FrontDoor(server, api.FrontDoorConfig(max_wait_ms=1.0))
        real_collect = fd._collect
        failed_once = False

        def flaky(handle):
            nonlocal failed_once
            if not failed_once:
                failed_once = True
                raise RuntimeError("device fell over")
            return real_collect(handle)

        fd._collect = flaky
        with pytest.raises(RuntimeError, match="device fell over"):
            await fd.submit(q)
        out = await fd.submit(q)
        await fd.close()
        return out, fd.report()

    (mean, var), rep = asyncio.run(main())
    assert mean.shape == (1,) and var.shape == (1,)
    assert rep["requests"]["arrived"] == 2 and rep["requests"]["completed"] == 1


def test_replicated_lane_serves_through_the_front_door(fitted):
    server = api.Server(fitted)
    reqs = _requests(fitted, 6, seed=8)

    async def main():
        async with api.FrontDoor(server) as fd:
            return await asyncio.gather(*(fd.submit(q) for q in reqs))

    got = asyncio.run(main())
    for (mg, vg), q in zip(got, reqs, strict=True):
        ms, vs = server.submit(q)
        np.testing.assert_allclose(mg, ms, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vg, vs, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: the golden property through the fused (kernel) lane
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_frontdoor_golden_on_the_fused_lane(cuda_device, fitted):
    from repro_torch.kernels import predict

    server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined"),
                        device=cuda_device)
    assert server.backend == "fused"
    reqs = _requests(fitted, 64, seed=21)
    jitter = np.random.default_rng(22).uniform(0, 0.004, len(reqs))

    async def client(fd, i):
        await asyncio.sleep(float(jitter[i]))
        return await fd.submit(reqs[i])

    async def main():
        async with api.FrontDoor(server) as fd:
            got = await asyncio.gather(*(client(fd, i) for i in range(len(reqs))))
        return got, fd.report()

    predict.reset_launches()
    got, rep = asyncio.run(main())
    assert predict.LAUNCHES["posterior_predict_slots"] == rep["batches"]["count"]
    _assert_bitwise(got, [server.submit(q) for q in reqs], "cuda")
