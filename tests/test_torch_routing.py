"""The port's copied host router and its torch halo program against the
JAX package.

The router (tables, q_max policies, stacker, coalescer) is a verbatim
numpy copy, so its outputs must equal JAX's BITWISE, single-level and
two-level, on uniform and zipf streams. The device half (``blend_slots``,
``predict_routed``, the one-GPU halo program) is held to
``repro.core.routing.predict_routed`` through ``ref.tolerance_ratio``
(1e-5 of the magnitude of the summed terms), on caches whose leaves are
the JAX package's own.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blend as jblend
from repro.core import partition as jpart
from repro.core import posterior as jpost
from repro.core import routing as jrouting
from repro.core import svgp as jsvgp
from repro.data import spatial as jspatial
from repro.gp import covariances as jcov
from repro_torch.core import blend, partition, posterior, routing
from repro_torch.core.blend import blend_error_scales
from repro_torch.data import spatial
from repro_torch.gp import covariances as tcov
from repro_torch.kernels import ref
from repro_torch.launch import serve_sharded as ss

TABLE_FIELDS = ("xq", "qmask", "corner_slot", "corner_w", "src_idx", "counts", "owner")


def _grid(side=4):
    x = np.random.default_rng(0).uniform(0, 4, (500, 2)).astype(np.float32)
    return jpart.make_grid(x, side, side), partition.make_grid(x, side, side)


def _streams(tgrid, n=300, requests=3):
    rng = np.random.default_rng(1)
    lo = [tgrid.x_edges[0], tgrid.y_edges[0]]
    hi = [tgrid.x_edges[-1], tgrid.y_edges[-1]]
    uniform = [rng.uniform(lo, hi, (n, 2)).astype(np.float32) for _ in range(requests)]
    return {
        "uniform": uniform,
        "zipf": spatial.zipf_query_stream(tgrid, n, requests, alpha=1.1, seed=2),
    }


def _assert_tables_equal(t, j):
    for f in TABLE_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_grid_cells_corners_and_data_copies_equal_jax():
    jg, tg = _grid(5)
    for a, b in zip(tg, jg, strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    pts = np.random.default_rng(3).uniform(-1, 5, (200, 2)).astype(np.float32)
    for a, b in zip(partition.cell_indices(tg, pts), jpart.cell_indices(jg, pts), strict=True):
        assert np.array_equal(a, b)
    assert np.array_equal(partition.partition_centers(tg), jpart.partition_centers(jg))
    for a, b in zip(blend.corner_ids_weights(tg, pts), jblend.corner_ids_weights(jg, pts),
                    strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ds_t, ds_j = spatial.e3sm_like_field(n=300, seed=4), jspatial.e3sm_like_field(n=300, seed=4)
    for a, b in zip(ds_t, ds_j, strict=True):
        assert np.array_equal(a, b)
    for a, b in zip(spatial.zipf_query_stream(tg, 50, 2, seed=5),
                    jspatial.zipf_query_stream(jg, 50, 2, seed=5), strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_single_level_tables_and_policy_equal_jax_bitwise(kind):
    jg, tg = _grid()
    tp, jp = routing.StreamingQMax(), jrouting.StreamingQMax()
    for q in _streams(tg)[kind]:
        cells = routing.owning_cells(tg, q)
        counts = np.bincount(cells[1] * tg.gx + cells[0], minlength=tg.num_partitions)
        qm = tp.fit(counts)
        assert qm == jp.fit(counts)
        _assert_tables_equal(routing.build_routing_table(tg, q, q_max=qm, cells=cells),
                             jrouting.build_routing_table(jg, q, q_max=qm))
    assert tp.stats() == jp.stats()
    q = _streams(tg)[kind][0]
    _assert_tables_equal(routing.build_routing_table(tg, q), jrouting.build_routing_table(jg, q))


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_two_level_tables_and_policy_equal_jax_bitwise(kind):
    jg, tg = _grid()
    tp, jp = routing.TwoLevelQMax(), jrouting.TwoLevelQMax()
    for q in _streams(tg)[kind]:
        cells = routing.owning_cells(tg, q)
        own = cells[1] * tg.gx + cells[0]
        corners = blend.corner_ids_weights(tg, q)
        qm, hosts = tp.fit_spill(tg, own, corners[0])
        jqm, jhosts = jp.fit_spill(jg, own, corners[0])
        assert qm == jqm and np.array_equal(hosts, jhosts)
        t = routing.build_routing_table(tg, q, q_max=qm, corners=corners, spill=True, hosts=hosts)
        j = jrouting.build_routing_table(jg, q, q_max=qm, spill=True)
        _assert_tables_equal(t, j)
        assert t.num_spilled() == j.num_spilled()
    assert tp.stats() == jp.stats()
    assert routing.min_spill_q_max(own, corners[0], tg.num_partitions) == \
        jrouting.min_spill_q_max(own, corners[0], jg.num_partitions)


def test_halo_tables_stacker_coalesce_and_scatter_equal_jax():
    jg, tg = _grid(3)
    assert np.array_equal(routing.halo_ids(tg), jrouting.halo_ids(jg))
    assert np.array_equal(routing.halo_slot_on_grid(tg), jrouting.halo_slot_on_grid(jg))
    q = _streams(tg)["uniform"][0]
    table = routing.build_routing_table(tg, q)
    assert np.array_equal(routing.make_halo_stacker(tg)(table.xq),
                          jrouting.make_halo_stacker(jg)(table.xq))
    reqs = [q[:3], q[3:10], q[10:11]]
    pts, sizes = routing.coalesce_requests(reqs)
    jpts, jsizes = jrouting.coalesce_requests(reqs)
    assert np.array_equal(pts, jpts) and np.array_equal(sizes, jsizes)
    vals = np.arange(table.xq.shape[0] * table.q_max, dtype=np.float32).reshape(table.qmask.shape)
    assert np.array_equal(routing.scatter_results(table, vals),
                          jrouting.scatter_results(table, vals))
    out = routing.demux_results(sizes, pts[:, 0])
    assert [len(o[0]) for o in out] == [3, 7, 1]


def test_blend_slots_matches_jax():
    rng = np.random.default_rng(6)
    P, q = 5, 12
    res_m = rng.normal(0, 1, (P, 9, q)).astype(np.float32)
    res_v = rng.uniform(0.1, 1, (P, 9, q)).astype(np.float32)
    slots = rng.integers(0, 9, (P, q, 4)).astype(np.int32)
    w = rng.dirichlet(np.ones(4), (P, q)).astype(np.float32)
    got = routing.blend_slots(torch.as_tensor(res_m), torch.as_tensor(res_v),
                              torch.as_tensor(slots.astype(np.int64)), torch.as_tensor(w))
    want = jax.vmap(jrouting.blend_slots)(*map(jnp.asarray, (res_m, res_v, slots, w)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)


def _caches(side=4, m=5, seed=7):
    """A JAX-built P-stacked cache and the port's copy of its leaves."""
    rng = np.random.default_rng(seed)
    P = side * side
    jg, tg = _grid(side)
    # inducing points spread over each cell (a well-conditioned Kmm, like a
    # fitted model's): the cell center and four points around it
    spread = np.array([[0, 0], [-1, -1], [1, -1], [-1, 1], [1, 1]])[:m] * 0.3
    z = jpart.partition_centers(jg)[:, None, :] + spread + rng.uniform(-0.05, 0.05, (P, m, 2))

    def a(v):
        return jnp.asarray(np.asarray(v, np.float32))

    params = jsvgp.SVGPParams(
        m_star=a(rng.normal(0, 1, (P, m))), s_tril=a(rng.normal(0, 0.3, (P, m, m))), z=a(z),
        cov=jcov.CovarianceParams(a(np.log(rng.uniform(0.3, 0.4, (P, 2)))),
                                  a(rng.normal(0, 0.2, P))),
        log_beta=a(rng.normal(2, 0.2, P)),
    )
    jc = jpost.build_cache_stacked(params, jcov.rbf)
    t = [torch.as_tensor(np.array(v)) for v in jax.tree.leaves(jc)]
    tc = posterior.PosteriorCache(z=t[0], w=t[1], u=t[2], c=t[3],
                                  cov=tcov.CovarianceParams(t[4], t[5]), log_beta=t[6])
    return jg, tg, jc, tc


def _agree(tc, tg, q, got, want):
    mean_s, var_s = blend_error_scales(tc, tg, q)
    assert ref.tolerance_ratio(torch.as_tensor(got[0]), torch.as_tensor(np.array(want[0])),
                               mean_s) <= 1
    assert ref.tolerance_ratio(torch.as_tensor(got[1]), torch.as_tensor(np.array(want[1])),
                               var_s) <= 1


@pytest.mark.parametrize("spill", [False, True])
def test_predict_routed_and_halo_program_match_jax(spill):
    jg, tg, jc, tc = _caches()
    q = _streams(tg, n=400)["zipf"][0]
    if spill:
        corners = blend.corner_ids_weights(tg, q)
        own = np.asarray(routing.owning_cells(tg, q))
        own = own[1] * tg.gx + own[0]
        qm, hosts = routing.TwoLevelQMax().fit_spill(tg, own, corners[0])
        table = routing.build_routing_table(tg, q, q_max=qm, spill=True, hosts=hosts)
        assert table.num_spilled() > 0
    else:
        table = routing.build_routing_table(tg, q)
    want = jrouting.predict_routed(jc, jcov.rbf, jg, table)
    for use_pallas in (False, True):
        _agree(tc, tg, q, routing.predict_routed(tc, tcov.rbf, tg, table, use_pallas=use_pallas),
               want)
    hx = torch.as_tensor(routing.make_halo_stacker(tg)(table.xq))
    cs = torch.as_tensor(table.corner_slot.astype(np.int64))
    cw = torch.as_tensor(table.corner_w)
    for backend in ("ref", "pallas", "fused"):
        blend_fn = ss.make_halo_blend(tg, tcov.rbf, backend, torch.device("cpu"))
        mean, var = blend_fn(tc, hx, cs, cw)
        got = (routing.scatter_results(table, mean.numpy()),
               routing.scatter_results(table, var.numpy()))
        _agree(tc, tg, q, got, want)


def test_halo_program_refuses_non_rbf_kernel_lanes_and_wrapped_grids():
    _, tg, _, _ = _caches(side=3)
    ss.make_halo_blend(tg, tcov.matern32, "ref", torch.device("cpu"))
    with pytest.raises(ValueError, match="only the 'rbf'"):
        ss.make_halo_blend(tg, tcov.matern32, "fused", torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        ss.make_halo_blend(tg._replace(wrap_x=True), tcov.rbf, "ref", torch.device("cpu"))


def test_request_stages_match_predict_routed_and_need_one_router():
    _, tg, _, tc = _caches(side=3)
    blend_fn = ss.make_halo_blend(tg, tcov.rbf, "fused", torch.device("cpu"))
    with pytest.raises(ValueError, match="exactly one"):
        ss.make_request_stages(tg, blend_fn, tc, device=torch.device("cpu"))
    route, submit, collect = ss.make_request_stages(
        tg, blend_fn, tc, device=torch.device("cpu"), q_max=64
    )
    q = _streams(tg, n=100)["uniform"][0]
    table, blocks = route(q)
    assert table.q_max == 64 and blocks[0].shape == (9, 9, 64, 2)
    mean, var = collect(submit((table, blocks)))
    want = routing.predict_routed(tc, tcov.rbf, tg, table)
    np.testing.assert_allclose(mean, want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, want[1], rtol=1e-5, atol=1e-6)
    assert ss.cache_memory_bytes(tc)[0] == sum(
        a.numel() * 4 for a in posterior.cache_leaves(tc))
