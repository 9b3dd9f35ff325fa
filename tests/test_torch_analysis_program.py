"""The port's program passes (``repro_torch.analysis``: ``hlo``, ``contracts``,
``costs`` and their manifest ``invariants``), on the CPU.

Mirrors the program-pass tests of ``tests/test_analysis.py``:

  * the manifest validates and rejects bad declarations; synthetic trace
    texts trip each ``hlo`` rule, and exactly that rule; budget, floor,
    the replicated lane's zero collectives, the f64 exemption (per lane,
    per op site) and manifest rot;
  * the cost gates judge correctly (healthy, growth, blow-up, ceiling,
    drift records), and the contract machinery catches a missing
    declaration, an unknown invariant and a stale shape;
  * parity with the JAX package: every JAX lane has a port lane, and
    ``fit_exponent``, ``parse_shape``, ``unify``, ``check_budget`` and
    ``check_baseline`` of both packages return the same findings on the
    same records (JAX's ``analysis/costs.py``, ``contracts.py`` and
    ``invariants.py`` import no jax);
  * injected violations in REAL lanes, each caught by exactly its rule: a
    second kernel dispatch, an f64 output, an ``.item()`` in the device
    stage and a pairwise q_max^2 term in the one-process program (in
    process); an extra ``dist.all_reduce`` of a cache leaf, a fifth shift
    and a rank holding the whole cache on the mesh (spawned gloo ranks);
  * the shipped lanes are clean: the five-pass CLI (in process, its mesh
    probes from the one spawn of ranks this module makes), its exit codes
    and the ``--update-baselines`` round trip.
"""
from __future__ import annotations

import contextlib
import json

import pytest
import torch

from repro_torch.analysis import Finding, contracts, costs, hlo, meshprobe
from repro_torch.analysis import invariants as inv
from repro_torch.analysis.__main__ import main as cli_main


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(findings):
    return sorted({f.rule for f in findings})


def _lane(name):
    return next(lane for lane in inv.LANES if lane.name == name)


MESH_FUSED = _lane("mesh/serial/single/fused")
ONE_FUSED = _lane("sharded/serial/single/fused")
ONE_REF = _lane("sharded/serial/single/ref")
REPLICATED = _lane("replicated/serial/single/ref")
EXEMPT_SITE = inv.F64_SITES[0]


# --------------------------------------------------------------------------
# Finding / manifest basics
# --------------------------------------------------------------------------


def test_finding_validates_the_five_passes():
    with pytest.raises(ValueError):
        Finding("vibes", "R", "w", "m")
    f = Finding("hlo", "HLO-FORBIDDEN-OP", "lane:x", "boom")
    assert f.to_dict()["rule"] == "HLO-FORBIDDEN-OP" and "lane:x" in str(f)


def test_lane_manifest_is_valid_serve_configs():
    from repro_torch.api.config import ServeConfig

    names = [lane.name for lane in inv.LANES]
    assert len(names) == 26 and len(set(names)) == len(names)
    for lane in inv.LANES:
        ServeConfig.from_dict(lane.serve)  # manifest rot raises
    # 7 programs behind the 26 lanes: replicated, one-process x 3, mesh x 3
    assert len({lane.program_key for lane in inv.LANES}) == 7
    for lane in inv.LANES:
        if lane.program == "mesh-blend":
            assert lane.exact["collective-permute"] == 4 and lane.exact["all-gather"] == 1
            assert (lane.min_collective_permute, lane.max_collective_permute) == (4, 8)
            assert "all-gather" not in lane.forbidden_ops
        else:
            assert lane.forbidden_ops == inv.COLLECTIVE_OPS
        assert lane.exact["kernel"] == int(lane.backend != "ref")
        assert bool(lane.f64_sites) == (lane.backend == "ref")


def test_every_jax_lane_has_a_port_lane():
    from repro.analysis import invariants as jinv

    port = {lane.name: lane for lane in inv.LANES}
    for jl in jinv.LANES:
        assert jl.name in port, jl.name
        assert port[jl.name].serve == jl.serve and port[jl.name].backend == jl.backend
    assert jinv.PPERMUTE_BUDGET == inv.PPERMUTE_BUDGET
    assert jinv.COLLECTIVE_OPS == inv.COLLECTIVE_OPS


_BAD_LANES = [
    dict(program="warp-drive"),
    dict(max_collective_permute=2, min_collective_permute=4),
    dict(forbidden_ops=("warp-gather",)),
    dict(exact={"warp": 1}),
    dict(exact={"kernel": -1}),
    dict(host_copies=("teleport",)),
    dict(backend="fused", f64_sites=inv.F64_SITES, f64_reason="why not"),  # no spreading
    dict(f64_sites=inv.F64_SITES),  # no reason
    dict(f64_sites=("no-function-here",), f64_reason="r"),
    dict(program="replicated-blend", backend="fused"),
]


@pytest.mark.parametrize("bad", _BAD_LANES, ids=lambda d: ",".join(sorted(d)))
def test_lane_invariant_rejects_bad_declarations(bad):
    kw = dict(name="x", serve={}, program="sharded-blend", backend="ref",
              max_collective_permute=8, forbidden_ops=())
    with pytest.raises(ValueError):
        inv.LaneInvariant(**{**kw, **bad})


# --------------------------------------------------------------------------
# hlo: checks on synthetic trace texts
# --------------------------------------------------------------------------

SITE = "site=repro_torch/launch/serve_sharded.py:resolve"


def _shift(payload="float32[3,2,64]", leaf="no"):
    return (f"collective collective-permute stage=collect payload={payload} dev=cpu "
            f"cache-leaf={leaf} via=dist.batch_isend_irecv {SITE}")


MESH_GOOD = "\n".join([
    "# program mesh-blend/fused device=cpu grid=4 m=8 q_max=64 n_queries=512 rank=5",
    "# halo-mesh shifts=4 gathers=1",
    "input 0 dtype=float32[1,9,64,2] dev=host",
    "kernel posterior_predict_slots_stacked n=1 stage=submit out=float32,float32 dev=cpu "
    f"{SITE}",
    "op aten.stack.default stage=submit out=float32 dev=cpu " + SITE,
    "host-copy aten.copy_.default stage=submit out=float32 " + SITE,
    *[_shift() for _ in range(4)],
    "collective all-gather stage=collect payload=float32[2,64] dev=cpu cache-leaf=no "
    "via=dist.all_gather " + SITE,
    "host-copy aten._to_copy.default stage=collect out=float32 " + SITE,
    "output 0 dtype=float32[1,64] dev=cpu",
])


def test_hlo_good_text_is_clean():
    findings, counts = hlo.check_text(MESH_FUSED, MESH_GOOD)
    assert findings == []
    assert counts["collective-permute"] == 4 and counts["all-gather"] == 1
    assert counts["kernel"] == 1 and counts["host-copy"] == 2


@pytest.mark.parametrize(
    "mutation,rule",
    [
        # a re-aggregating collective, by wrapper or by c10d op
        ("collective all-reduce stage=collect payload=float32[8,8] dev=cpu cache-leaf=no "
         "via=dist.all_reduce " + SITE, "HLO-FORBIDDEN-OP"),
        ("collective reduce-scatter stage=collect payload=float32[8] dev=cpu cache-leaf=no "
         "via=c10d.reduce_scatter_ " + SITE, "HLO-FORBIDDEN-OP"),
        # an unknown collective
        ("collective c10d.broadcast_ stage=collect payload=float32[8] dev=cpu cache-leaf=no "
         "via=c10d.broadcast_ " + SITE, "HLO-FORBIDDEN-OP"),
        # an f64 op outside any declared site, an f64 payload, an f64 output
        ("op aten.mul.Tensor stage=submit out=float64 dev=cpu " + SITE, "HLO-DTYPE-F64"),
        ("output 1 dtype=float64[1,64] dev=cpu", "HLO-DTYPE-F64"),
        ("input 3 dtype=float64[1,64,4] dev=host", "HLO-DTYPE-F64"),
        # a host read inside the request, an undeclared host copy
        ("scalar-read aten._local_scalar_dense stage=submit " + SITE, "HLO-HOST-TRANSFER"),
        ("host-copy aten._to_copy.default stage=submit out=float32 " + SITE,
         "HLO-HOST-TRANSFER"),
        # a second kernel dispatch, a fifth shift
        ("kernel posterior_predict_slots_stacked n=1 stage=submit out=float32 dev=cpu " + SITE,
         "HLO-COLLECTIVE-BUDGET"),
        (_shift(), "HLO-COLLECTIVE-BUDGET"),
    ],
)
def test_hlo_bad_text_caught_by_exactly_the_expected_rule(mutation, rule):
    findings, _ = hlo.check_text(MESH_FUSED, MESH_GOOD + "\n" + mutation)
    assert _rules(findings) == [rule], findings


def test_a_shift_carrying_a_cache_leaf_is_forbidden():
    text = MESH_GOOD.replace(_shift(), _shift(leaf="yes"), 1)
    findings, _ = hlo.check_text(MESH_FUSED, text)
    assert _rules(findings) == ["HLO-FORBIDDEN-OP"] and "cache leaf" in findings[0].message


def test_an_f64_collective_payload_is_caught():
    text = MESH_GOOD.replace(_shift(), _shift(payload="float64[3,2,64]"), 1)
    findings, _ = hlo.check_text(MESH_FUSED, text)
    assert _rules(findings) == ["HLO-DTYPE-F64"]


def test_hlo_budget_and_floor():
    over = MESH_GOOD + "\n" + "\n".join(_shift() for _ in range(9))
    findings, counts = hlo.check_text(MESH_FUSED, over)
    assert _rules(findings) == ["HLO-COLLECTIVE-BUDGET"] and counts["collective-permute"] == 13
    # the floor: the halo vanished from the program
    under = MESH_GOOD.replace(_shift() + "\n", "", 1).replace(
        "# halo-mesh shifts=4", "# halo-mesh shifts=3")
    findings, _ = hlo.check_text(MESH_FUSED, under)
    assert _rules(findings) == ["HLO-COLLECTIVE-MISSING"]
    # the kernel vanished
    no_kernel = "\n".join(l for l in MESH_GOOD.splitlines() if not l.startswith("kernel"))
    findings, _ = hlo.check_text(MESH_FUSED, no_kernel)
    assert _rules(findings) == ["HLO-COLLECTIVE-MISSING"]
    # the recorder stopped seeing shifts that HaloMesh counted
    rotted = MESH_GOOD.replace("shifts=4", "shifts=6")
    findings, _ = hlo.check_text(MESH_FUSED, rotted)
    assert _rules(findings) == ["HLO-COLLECTIVE-MISSING"]
    assert "rotted" in findings[0].message


def test_hlo_one_process_floor_is_the_kernel_and_the_reverse_halo_gather():
    gather = "op aten.index.Tensor stage=submit out=float32 dev=cpu " + SITE
    kernel = "kernel posterior_predict_slots_stacked n=1 stage=submit out=float32 dev=cpu " + SITE
    copies = "\n".join(["host-copy aten._to_copy.default stage=collect out=float32 " + SITE] * 2)
    good = "\n".join([kernel, gather, gather, copies])
    assert hlo.check_text(ONE_FUSED, good)[0] == []
    assert _rules(hlo.check_text(ONE_FUSED, "\n".join([kernel, gather, copies]))[0]) == [
        "HLO-COLLECTIVE-MISSING"]
    assert _rules(hlo.check_text(ONE_FUSED, "\n".join([gather, gather]))[0]) == [
        "HLO-COLLECTIVE-MISSING"]
    # any collective at all on the one-process program
    findings, _ = hlo.check_text(ONE_FUSED, good + "\n" + _shift())
    assert _rules(findings) == ["HLO-COLLECTIVE-BUDGET", "HLO-FORBIDDEN-OP"]


def test_hlo_f64_exemption_is_per_lane_and_per_site():
    f64_op = f"op aten.addcmul_.default stage=submit out=float64 dev=cpu site={EXEMPT_SITE}"
    gather = "op aten.index.Tensor stage=submit out=float32 dev=cpu " + SITE
    base = "\n".join([gather, gather])
    findings, counts = hlo.check_text(ONE_REF, base + "\n" + f64_op)
    assert findings == [] and counts["f64-ops"] == {"aten.addcmul_.default": 1}
    # the same op on a kernel lane, or at another site, or f64 reaching an output
    kernel = "kernel posterior_predict_slots_stacked n=1 stage=submit out=float32 dev=cpu " + SITE
    findings, _ = hlo.check_text(ONE_FUSED, "\n".join([kernel, base, f64_op]))
    assert _rules(findings) == ["HLO-DTYPE-F64"]
    other = f64_op.replace(EXEMPT_SITE, "repro_torch/core/routing.py:blend_slots")
    assert _rules(hlo.check_text(ONE_REF, base + "\n" + other)[0]) == ["HLO-DTYPE-F64"]
    out = "output 0 dtype=float64[16,64] dev=cpu"
    assert _rules(hlo.check_text(ONE_REF, base + "\n" + out)[0]) == ["HLO-DTYPE-F64"]


def test_hlo_replicated_lane_forbids_all_collectives():
    findings, _ = hlo.check_text(REPLICATED, _shift())
    assert "HLO-COLLECTIVE-BUDGET" in _rules(findings)
    findings, _ = hlo.check_text(
        REPLICATED, "collective all-reduce stage=submit payload=float32[8] dev=cpu "
        "cache-leaf=no via=dist.all_reduce " + SITE)
    assert _rules(findings) == ["HLO-FORBIDDEN-OP"]


def test_hlo_manifest_rot_is_a_finding():
    rotten = inv.LaneInvariant(
        name="rotten", serve={"mode": "sharded", "warp_factor": 9},
        program="sharded-blend", backend="ref",
        max_collective_permute=8, forbidden_ops=(),
    )
    findings, report = hlo.run(lanes=(rotten,))
    assert _rules(findings) == ["HLO-MANIFEST"]
    assert report["lanes"] == [] and report["programs_recorded"] == []  # never driven


# --------------------------------------------------------------------------
# costs: pure judgment on synthetic records, beside the JAX package's
# --------------------------------------------------------------------------


def _mk_mesh(mem_exp=0.0, q_exp=1.0, program="mesh-blend"):
    """A synthetic per-rank record shaped like the real one: flat per rank
    (unless ``mem_exp``), linear in q_max (unless ``q_exp``)."""
    points, axes = {}, {"devices": {}, "q_max": {}}
    for side in (2, 3, 4):
        p = side * side
        lab = f"grid={side}/q=64"
        points[lab] = {
            "flops": 142358.0, "bytes_accessed": 2351780.0,
            "arg_bytes": int(8304 * (p / 16) ** mem_exp),
            "out_bytes": 512, "temp_bytes": 99584,
        }
        axes["devices"][lab] = p
    for q in (32, 64, 128):
        lab = f"grid=4/q={q}"
        points.setdefault(lab, {
            "flops": 142358.0 * (q / 64) ** q_exp,
            "bytes_accessed": 2351780.0 * q / 64,
            "arg_bytes": int(8304 * q / 64),
            "out_bytes": 512 * q // 64, "temp_bytes": 99584 * q // 64,
        })
        axes["q_max"][lab] = q
    rec = {"points": points, "axes": axes}
    rec["exponents"] = costs.compute_exponents(rec)
    return rec


MESH_BUDGET = inv.COST_BUDGETS["mesh-blend"]


def _jax_pair():
    """JAX's costs module and the mesh budget as a JAX CostBudget (its
    sharded-blend program name; the fields are the port's)."""
    import dataclasses

    from repro.analysis import costs as jcosts
    from repro.analysis import invariants as jinv

    fields = dataclasses.asdict(MESH_BUDGET)
    fields["program"] = "sharded-blend"
    return jcosts, jinv.CostBudget(**fields)


def _keys(findings):
    return sorted((f.pass_name, f.rule, f.where) for f in findings)


def test_cost_budget_rejects_bad_declarations():
    kw = dict(scale_axis="q_max", anchor="a", max_flop_exponent=1.3,
              max_flops=1.0, max_bytes_accessed=1.0, max_arg_bytes=1,
              max_temp_bytes=1)
    with pytest.raises(ValueError):
        inv.CostBudget(program="warp-drive", **kw)
    with pytest.raises(ValueError):  # >= quadratic allowance is vacuous
        inv.CostBudget(program="mesh-blend", **{**kw, "max_flop_exponent": 2.0})
    with pytest.raises(ValueError):
        inv.CostBudget(program="mesh-blend", **{**kw, "max_flops": 0.0})
    with pytest.raises(ValueError):
        inv.CostBudget(program="mesh-blend", **kw, max_device_exponent=1.5)
    assert set(inv.COST_BUDGETS) == {"replicated-blend", "sharded-blend", "mesh-blend"}
    # only the mesh claims 1/P residency: the one-process program holds every cell
    assert [n for n, b in inv.COST_BUDGETS.items() if b.max_device_exponent is not None] == [
        "mesh-blend"]


@pytest.mark.parametrize("xs,ys,want", [
    ([32, 64, 128], [10, 20, 40], 1.0),
    ([2, 4, 8], [4, 16, 64], 2.0),
    ([4, 9, 16], [7, 7, 7], 0.0),
    ([4, 9, 16], [10176, 13296, 17664], None),
])
def test_fit_exponent_matches_jax(xs, ys, want):
    jcosts, _ = _jax_pair()
    got = costs.fit_exponent(xs, ys)
    assert got == jcosts.fit_exponent(xs, ys)
    if want is not None:
        assert got == pytest.approx(want)
    for bad in (([2], [4]), ([2, 2], [4, 8])):
        with pytest.raises(ValueError):
            costs.fit_exponent(*bad)


@pytest.mark.parametrize("case,rules", [
    ("healthy", []),
    ("growth", ["COST-MEM-SCALING"]),
    ("blowup", ["COST-FLOP-SUPERLINEAR"]),
    ("ceiling", ["COST-BUDGET"]),
    ("anchor", ["COST-BUDGET"]),
])
def test_check_budget_records_and_parity_with_jax(case, rules):
    import dataclasses

    jcosts, jbudget = _jax_pair()
    rec = _mk_mesh(mem_exp=0.5 if case == "growth" else 0.0,
                   q_exp=2.0 if case == "blowup" else 1.0)
    budget = MESH_BUDGET
    if case == "ceiling":
        for lab in rec["points"]:
            rec["points"][lab]["temp_bytes"] = 10_000_000
        rec["exponents"] = costs.compute_exponents(rec)
    if case == "anchor":
        budget = dataclasses.replace(MESH_BUDGET, anchor="grid=9/q=9")
        jbudget = dataclasses.replace(jbudget, anchor="grid=9/q=9")
    findings = costs.check_budget("mesh-blend/ref", rec, budget)
    assert _rules(findings) == rules, findings
    assert _keys(findings) == _keys(jcosts.check_budget("mesh-blend/ref", rec, jbudget))


def test_check_baseline_drift_missing_improvement_and_parity_with_jax():
    jcosts, _ = _jax_pair()
    rec = _mk_mesh()
    base = {"points": {lab: dict(m) for lab, m in rec["points"].items()}}
    worse = _mk_mesh()
    worse["points"]["grid=4/q=64"]["flops"] *= 2
    better = _mk_mesh()
    better["points"]["grid=4/q=64"]["flops"] /= 2
    short = {"points": {k: v for k, v in base["points"].items() if k != "grid=4/q=128"}}
    cases = [(rec, base, []), (worse, base, ["COST-BASELINE-DRIFT"]), (better, base, []),
             (rec, short, ["COST-BASELINE-MISSING"]), (rec, None, ["COST-BASELINE-MISSING"])]
    for fresh, baseline, rules in cases:
        findings = costs.check_baseline("mesh-blend/ref", fresh, baseline)
        assert _rules(findings) == rules, findings
        assert _keys(findings) == _keys(jcosts.check_baseline("mesh-blend/ref", fresh, baseline))
    assert "--update-baselines" in costs.check_baseline("p", rec, None)[0].message
    assert costs.DRIFT_TOLERANCE == jcosts.DRIFT_TOLERANCE and costs.METRICS == jcosts.METRICS


def test_card_memory_growth_is_a_finding():
    rec = _mk_mesh()
    rec["cuda_peak_bytes"] = {"grid=2/q=64": [200_000] * 4, "grid=3/q=64": [200_000] * 9,
                              "grid=4/q=64": [200_000] * 16}
    assert costs.check_device_memory("mesh-blend/ref", rec, MESH_BUDGET) == []
    assert rec["cuda_peak_exponent"] == 0.0
    rec["cuda_peak_bytes"]["grid=4/q=64"] = [800_000] * 16
    findings = costs.check_device_memory("mesh-blend/ref", rec, MESH_BUDGET)
    assert _rules(findings) == ["COST-MEM-SCALING"]
    # no device budget (the one-process program): nothing to hold
    assert costs.check_device_memory("x", rec, inv.COST_BUDGETS["sharded-blend"]) == []


def test_lane_cost_records_cover_every_lane():
    replicated = {"points": {"n=256": {"flops": 1.0}}, "exponents": {}}
    programs = {"mesh-blend/ref": _mk_mesh(), "sharded-blend/ref": _mk_mesh(),
                "replicated-blend/ref": replicated}
    records = costs.lane_cost_records(programs)
    assert len(records) == len(inv.LANES)
    skipped = [r for r in records if "skipped" in r]
    assert skipped and all(r["program"].endswith(("/pallas", "/fused")) for r in skipped)
    assert all(r["anchor_cost"] for r in records if "skipped" not in r)


# --------------------------------------------------------------------------
# contracts
# --------------------------------------------------------------------------


def test_parse_and_unify_match_jax():
    from repro.analysis import contracts as jc

    for expr in ("(S, Q, 4)", "(N,)", "(P, 9, Q, 2)"):
        assert contracts.parse_shape(expr) == jc.parse_shape(expr)
    assert contracts.parse_shape("(S, Q, 4)") == ("S", "Q", 4)
    env, jenv = {}, {}
    for expr, shape in (("(S, Q)", (9, 64)), ("(S, 4)", (9, 4)), ("(S, Q)", (8, 64)),
                        ("(S, Q)", (9,)), ("(S, 4)", (9, 5))):
        assert contracts.unify(expr, shape, env) == jc.unify(expr, shape, jenv)
    assert env == jenv == {"S": 9, "Q": 64}
    with pytest.raises(ValueError):
        contracts.parse_shape("S, Q")
    assert contracts.KNOWN_INVARIANTS == jc.KNOWN_INVARIANTS
    assert [t.replace("repro_torch.", "repro.") for t in contracts.EXPECTED_TARGETS] == list(
        jc.EXPECTED_TARGETS)


def test_the_contracts_are_jax_s():
    import importlib

    from repro.analysis import contracts as jc

    contracts.run(targets=())  # imports the targets: the decorators register
    for target in contracts.EXPECTED_TARGETS:
        jtarget = target.replace("repro_torch.", "repro.")
        importlib.import_module(jtarget.rsplit(".", 1)[0])
        assert contracts._REGISTRY[target].spec == jc._REGISTRY[jtarget].spec, target


def test_a_removed_contract_is_a_finding():
    target = contracts.EXPECTED_TARGETS[1]  # scatter_results, host-only
    contracts.run(targets=())
    saved = contracts._REGISTRY.pop(target)
    try:
        findings, _ = contracts.run(targets=(target,))
        assert _rules(findings) == ["CONTRACT-MISSING"]
    finally:
        contracts._REGISTRY[target] = saved


def test_unknown_invariant_name_is_a_finding():
    decl = contracts.ContractDecl(
        target="repro_torch.core.routing.scatter_results",
        spec={"returns": "(N,)", "invariants": ("made-up-claim",)},
    )
    assert _rules(contracts.harness_scatter_results(decl)) == ["CONTRACT-DECL"]


def test_stale_shape_declaration_fails():
    decl = contracts.ContractDecl(
        target="repro_torch.core.routing.scatter_results",
        spec={"args": {"values": "(P, Q, 3)"}, "returns": "(N,)"},
    )
    assert _rules(contracts.harness_scatter_results(decl)) == ["CONTRACT-SHAPE"]
    stale = contracts.ContractDecl(
        target="repro_torch.launch.serve_sharded.make_sharded_blend",
        spec={"args": {"hx": "(P, 9, Q, 3)"}, "returns": ("(P, Q)", "(P, Q)")},
    )
    assert _rules(contracts.harness_make_sharded_blend(stale)) == ["CONTRACT-SHAPE"]


def test_every_contract_is_clean_on_fake_tensors():
    findings, report = contracts.run()
    assert findings == [], [str(f) for f in findings]
    assert report["targets_checked"] == list(contracts.EXPECTED_TARGETS)


# --------------------------------------------------------------------------
# Injected violations in REAL lanes
# --------------------------------------------------------------------------


def _one_process_injection(monkeypatch, variant):
    from repro_torch.core import posterior

    orig = posterior.predict_cached_slots_stacked

    def injected(*args, **kwargs):
        mean, var = orig(*args, **kwargs)
        if variant == "second-kernel-dispatch":
            mean, var = orig(*args, **kwargs)
        elif variant == "f64-output":
            mean = mean.double()
        elif variant == "item-in-device-stage":
            float(mean.sum())
        return mean, var

    monkeypatch.setattr(posterior, "predict_cached_slots_stacked", injected)


@pytest.mark.parametrize("variant,rule", [
    ("second-kernel-dispatch", "HLO-COLLECTIVE-BUDGET"),
    ("f64-output", "HLO-DTYPE-F64"),
    ("item-in-device-stage", "HLO-HOST-TRANSFER"),
])
def test_injected_one_process_violation_caught_by_exactly_its_rule(monkeypatch, variant, rule):
    clean, _ = hlo.run(lanes=(ONE_FUSED,))
    assert clean == []
    _one_process_injection(monkeypatch, variant)
    findings, _ = hlo.run(lanes=(ONE_FUSED,))
    assert _rules(findings) == [rule], findings


def test_injected_pairwise_q_term_caught_by_exactly_cost_flop_superlinear(monkeypatch):
    from repro_torch.core import routing

    orig = routing.blend_slots

    def pairwise(res_mean, res_var, corner_slot, corner_w):
        mean, var = orig(res_mean, res_var, corner_slot, corner_w)
        w = corner_w.repeat(1, 1, 4)  # (P, q, 16)
        return mean + 0.0 * (w @ w.mT).sum(-1), var  # a q x q term per cell

    monkeypatch.setattr(routing, "blend_slots", pairwise)
    plan = costs.scale_jobs()["sharded-blend/ref"]
    results = hlo.run_jobs([job for _, _, job in plan], "cpu")
    rec = {"points": {lab: results[job]["costs"] for lab, _, job in plan}, "axes": {}}
    for lab, axes, _ in plan:
        for axis, value in axes.items():
            rec["axes"].setdefault(axis, {})[lab] = value
    rec["exponents"] = costs.compute_exponents(rec)
    assert rec["exponents"]["flops_vs_q_max"] > 1.3, rec["exponents"]
    findings = costs.check_budget("sharded-blend/ref", rec, inv.COST_BUDGETS["sharded-blend"])
    assert _rules(findings) == ["COST-FLOP-SUPERLINEAR"], findings


@contextlib.contextmanager
def _inject(variant):
    """Faults injected into the mesh lane on every spawned rank."""
    import torch.distributed as dist

    from repro_torch.core import posterior
    from repro_torch.launch import serve_sharded as ss

    saved = (ss.shard_cache, ss.make_sharded_blend)
    held = {}

    def shard_cache(cache, mesh):
        if variant == "whole-cache-on-every-rank":  # views keep every cell alive
            local = posterior.map_cache(lambda a: a[mesh.rank:mesh.rank + 1], cache)
        else:
            local = saved[0](cache, mesh)
        held["local"] = local
        return local

    def make_sharded_blend(mesh, axes, grid, cov_fn, *, backend):
        program = saved[1](mesh, axes, grid, cov_fn, backend=backend)

        def resolve(ev, corner_slot, corner_w):
            if variant == "extra-all-reduce":
                dist.all_reduce(held["local"].w.clone(), group=mesh.group)
            elif variant == "fifth-shift":
                mesh.shift(ev.contiguous(), 1, 0)
            return program.resolve(ev, corner_slot, corner_w)

        return program._replace(resolve=resolve)

    ss.shard_cache, ss.make_sharded_blend = shard_cache, make_sharded_blend
    try:
        yield
    finally:
        ss.shard_cache, ss.make_sharded_blend = saved


def _cli_mesh_jobs():
    from repro_torch.analysis.__main__ import _mesh_jobs, build_parser

    return _mesh_jobs(("hlo", "costs"), build_parser().parse_args(["--device", "cpu"]))


MESH_HLO_JOB = hlo.probe_job(("mesh-blend", "fused"), grid_side=2, m=8, q_max=64, n_queries=0)
MESH_COST_JOBS = [job for lab, axes, job in costs.scale_jobs()["mesh-blend/ref"]
                  if "devices" in axes]


@pytest.fixture(scope="module")
def mesh_runs():
    """ONE spawn of 16 gloo ranks: the clean mesh probes of the CLI (kept
    by ``meshprobe`` for the CLI tests below) and every injected mesh
    fault."""
    pairs = [(job, None) for job in _cli_mesh_jobs()]
    pairs += [(MESH_HLO_JOB, "extra-all-reduce"), (MESH_HLO_JOB, "fifth-shift")]
    pairs += [(job, "whole-cache-on-every-rank") for job in MESH_COST_JOBS]
    return meshprobe.measure(pairs, "cpu", inject=_inject)


@pytest.mark.parametrize("variant,rule", [
    ("extra-all-reduce", "HLO-FORBIDDEN-OP"),
    ("fifth-shift", "HLO-COLLECTIVE-BUDGET"),
])
def test_injected_mesh_violation_caught_by_exactly_its_rule(mesh_runs, variant, rule):
    ranks = mesh_runs[(MESH_HLO_JOB, variant)]
    assert len(ranks) == 4
    for res in ranks:
        findings, counts = hlo.check_text(MESH_FUSED, res["trace"])
        assert _rules(findings) == [rule], findings
    if variant == "extra-all-reduce":
        assert counts["all-reduce"] == 1
        assert any("cache leaf" in f.message for f in findings)
    else:
        assert counts["collective-permute"] == 5 == res["mesh_stats"]["shifts"]


def test_a_rank_holding_the_whole_cache_caught_by_exactly_cost_mem_scaling(mesh_runs):
    clean = {lab: job for lab, _, job in costs.scale_jobs()["mesh-blend/ref"]}
    rec = {"points": {}, "axes": {"devices": {}, "q_max": {}}}
    for lab, axes, job in costs.scale_jobs()["mesh-blend/ref"]:
        key = (job, "whole-cache-on-every-rank") if "devices" in axes else (clean[lab], None)
        rec["points"][lab] = mesh_runs[key][0]["costs"]
        for axis, value in axes.items():
            rec["axes"][axis][lab] = value
    rec["exponents"] = costs.compute_exponents(rec)
    assert rec["exponents"]["arg_bytes_vs_devices"] > MESH_BUDGET.max_device_exponent
    findings = costs.check_budget("mesh-blend/ref", rec, MESH_BUDGET)
    assert _rules(findings) == ["COST-MEM-SCALING"], findings


# --------------------------------------------------------------------------
# The CLI: every lane clean on the shipped port
# --------------------------------------------------------------------------


def test_cli_full_run_clean_on_the_shipped_port(mesh_runs, tmp_path, capsys):
    out = tmp_path / "ANALYSIS_TORCH.json"
    assert cli_main(["--device", "cpu", "--out", str(out)]) == 0, capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["total_findings"] == 0
    assert set(report["passes"]) == {"hlo", "ast", "contracts", "costs", "async"}
    lanes = {rec["lane"]: rec for rec in report["passes"]["hlo"]["lanes"]}
    assert set(lanes) == {lane.name for lane in inv.LANES}
    for name, rec in lanes.items():
        assert {"collectives", "kernel_dispatches", "host_copies"} <= set(rec), name
        kernel = int(not name.endswith(("/ref", "/ref/fixed-q_max")))
        assert rec["kernel_dispatches"] == kernel, name
        if name.startswith("mesh/"):
            assert rec["collectives"]["collective-permute"] == 4, name
            assert rec["collectives"]["all-gather"] == 1, name
            assert rec["mesh_stats"] == {"shifts": 4, "gathers": 1} and rec["ranks"] == 16
        else:
            assert sum(rec["collectives"].values()) == 0, name
        assert bool(rec["f64_ops"]) == name.endswith(("/ref", "/ref/fixed-q_max")), name
    crec = report["passes"]["costs"]
    assert crec["baseline_checked"] is True
    exps = crec["programs"]["mesh-blend/ref"]["exponents"]
    assert exps["flops_vs_devices"] <= 0.05 and exps["arg_bytes_vs_devices"] <= 0.05
    assert 0.9 <= exps["flops_vs_q_max"] <= 1.1
    assert crec["programs"]["sharded-blend/ref"]["exponents"]["arg_bytes_vs_cells"] > 0.9
    assert report["passes"]["contracts"]["targets_skipped"] == []


def test_server_probe_keeps_one_cell_a_rank_at_every_p(mesh_runs):
    """The costs pass's ``Server(group=)`` probe (the CLI's spawn), built
    from a saved artifact as the torchrun CLI builds it: every rank
    reports total / P as its cache bytes and answers the whole request;
    the CPU has no CUDA numbers and no memory finding."""
    server = costs.measure_server(device="cpu")  # memoized by the spawn above
    assert sorted(server, key=int) == ["4", "9", "16"]
    for p, ranks in server.items():
        assert len(ranks) == int(p)
        for rec in ranks:
            total, per_rank = rec["cache_bytes"]
            assert per_rank * int(p) == total and rec["answers"] == 8 * int(p)
            assert rec["cuda_resident_bytes"] is None
    assert costs.check_server_memory(server, MESH_BUDGET) == []
    grown = {p: [dict(r, cuda_resident_bytes=200_000 * int(p)) for r in ranks]
             for p, ranks in server.items()}
    assert _rules(costs.check_server_memory(grown, MESH_BUDGET)) == ["COST-MEM-SCALING"]
    flat = {p: [dict(r, cuda_resident_bytes=300_000) for r in ranks]
            for p, ranks in server.items()}
    assert costs.check_server_memory(flat, MESH_BUDGET) == []


def test_cli_exits_1_on_cost_drift(mesh_runs, tmp_path):
    baseline = json.loads(open(costs.DEFAULT_BASELINE, encoding="utf-8").read())
    for rec in baseline["programs"].values():
        for metrics in rec["points"].values():
            metrics["flops"] = metrics["flops"] / 2
    stale = tmp_path / "stale_costs.json"
    stale.write_text(json.dumps(baseline))
    out = tmp_path / "report.json"
    rc = cli_main(["--passes", "costs", "--device", "cpu", "--baselines", str(stale),
                   "--out", str(out)])
    assert rc == 1
    assert {f["rule"] for f in json.loads(out.read_text())["findings"]} == {"COST-BASELINE-DRIFT"}


def test_cli_update_baselines_round_trip(mesh_runs, tmp_path):
    fresh = tmp_path / "fresh_costs.json"
    out = tmp_path / "report.json"
    argv = ["--passes", "costs", "--device", "cpu", "--baselines", str(fresh), "--out", str(out)]
    assert cli_main(argv) == 1  # no baseline yet
    assert {f["rule"] for f in json.loads(out.read_text())["findings"]} == {
        "COST-BASELINE-MISSING"}
    assert cli_main(argv + ["--update-baselines"]) == 0
    payload = json.loads(fresh.read_text())
    assert set(payload["programs"]) == {"replicated-blend/ref", "sharded-blend/ref",
                                        "mesh-blend/ref"}
    assert payload["_meta"]["tolerance"] == costs.DRIFT_TOLERANCE
    assert cli_main(argv) == 0
    report = json.loads(out.read_text())
    assert report["passes"]["costs"]["baseline_checked"] is True
    # the committed baseline is this run's numbers
    committed = json.loads(open(costs.DEFAULT_BASELINE, encoding="utf-8").read())
    assert committed["programs"] == payload["programs"]


def test_cli_rejects_an_unknown_pass_and_a_missing_card(tmp_path):
    assert cli_main(["--passes", "vibes", "--out", ""]) == 2
    if not torch.cuda.is_available():
        assert cli_main(["--passes", "hlo", "--out", ""]) == 2  # --device defaults to cuda
