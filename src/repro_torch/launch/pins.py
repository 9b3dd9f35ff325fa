"""Pinned cut cells of the dry-run: a few small traces whose records are
held to values kept here, on every torch version the port runs on.

The dry-run's record of a cell is the port's code run on DTensors, so a
torch release that changes how DTensor lays out an op the models leave to
it changes the record. Each cell here cuts a production cell's depth (or
sequence) so that it traces in seconds, and keeps its widths and mesh:

  qwen3_0_6b.prefill_32k    qwen3-0.6b at 1 layer, prefill_32k, 16 x 16
  qwen3_0_6b.train_4k       qwen3-0.6b at 1 layer, train_4k, 16 x 16
  minicpm3_4b.prefill_32k   minicpm3-4b at 1 layer, prefill_32k, 16 x 16
  xlstm_350m.prefill_128    xlstm-350m at one period (6 layers),
                            prefill_32k's batch at 128 positions, 16 x 16
  psvgp.gather_4x4          the PSVGP gather step on a 4 x 4 grid and mesh

What a cell is held to (:func:`check`): the collective kinds issued at
each model function (a site's file and the qualified name of the
function that issued it, so that an edit that moves lines leaves it),
the peak bytes a device, and the collective bytes by kind, the last two
within :data:`TOLERANCE`. The kinds, sites and peaks are recorded in
:data:`PINS`; where a cell's collective bytes follow from its shapes
(:func:`reckoned`), they are reckoned from them, and recorded only for
the rest. The tier-1 test (``tests/test_torch_dryrun_layout.py``) and
``chip_smoke.py``'s phase 16 both call :func:`check`. After a change to
the models' layouts, reprint the records with ``python -m
repro_torch.launch.pins`` and read the change.
"""
from __future__ import annotations

import dataclasses
import json

TOLERANCE = 0.05

# name -> (arch, shape, layers (None: one period), positions (None: the shape's))
CELLS = {
    "qwen3_0_6b.prefill_32k": ("qwen3_0_6b", "prefill_32k", 1, None),
    "qwen3_0_6b.train_4k": ("qwen3_0_6b", "train_4k", 1, None),
    "minicpm3_4b.prefill_32k": ("minicpm3_4b", "prefill_32k", 1, None),
    "xlstm_350m.prefill_128": ("xlstm_350m", "prefill_32k", None, 128),
    "psvgp.gather_4x4": ("psvgp", "gather", None, None),
}


def close(a: float, b: float) -> bool:
    """``a`` and ``b`` agree within :data:`TOLERANCE` of the larger."""
    return abs(a - b) <= TOLERANCE * max(abs(a), abs(b))


def trace_cell(name: str) -> dict:
    """The cell's record: ``peak`` (bytes a device), ``kinds`` (collective
    bytes by kind), ``sites`` (site function -> sorted kinds) and
    ``largest`` (the bytes of its largest collective, not pinned)."""
    from repro_torch.configs import get
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import MeshSpec, make_production_mesh

    arch, shape, layers, positions = CELLS[name]
    if arch == "psvgp":
        from repro_torch.configs.psvgp_e3sm import DRYRUN_SINGLE_POD

        exp = dataclasses.replace(DRYRUN_SINGLE_POD, grid=(4, 4))
        trace = dryrun.psvgp_gather_trace(MeshSpec(("data", "model"), (4, 4)), exp=exp)
    else:
        cfg = get(arch)
        cfg = dataclasses.replace(cfg, num_layers=layers or cfg.period)
        sh = INPUT_SHAPES[shape]
        if positions:
            sh = sh._replace(seq_len=positions)
        trace = dryrun.trace_combo(cfg, sh, make_production_mesh())
    sites: dict = {}
    for site, kind in trace.collective_sites():
        sites.setdefault(trace.functions[site], set()).add(kind)
    return {"peak": trace.memory()["peak_est"], "kinds": hlo_analysis.collective_bytes(trace),
            "sites": {s: sorted(k) for s, k in sorted(sites.items())},
            "largest": max((n for _, n, _ in trace.collectives), default=0)}


def reckoned(name: str) -> dict | None:
    """The collective bytes a device by kind of a cell whose collectives
    follow from its shapes, reckoned from them; None for a cell whose
    bytes are recorded in :data:`PINS`."""
    from repro_torch.configs import get
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape, layers, _ = CELLS[name]
    if arch == "psvgp":  # JAX's record at 4 x 4: x (2 columns), y and two masks gathered
        from repro_torch.launch.dryrun import N_MAX

        return {"all-gather": 16 * N_MAX * (2 + 1 + 2) * 4, "all-reduce": 4}  # the loss reduced
    if layers is None:
        return None
    cfg, sh = get(arch), INPUT_SHAPES[shape]
    S, B_l = sh.seq_len, sh.global_batch // make_production_mesh().shape["data"]
    act = B_l * S * 2  # bytes of one bf16 value at each of a rank's positions
    D, kv = cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim
    if cfg.mla is not None:  # 40 heads: attention splits over query rows
        m, H = cfg.mla, cfg.num_heads
        # gathered whole: q (nope and rope), the expanded keys and values,
        # and attention's output; summed: the embedding, wo and the MLP
        return {"all-gather": act * H * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                         + m.qk_nope_head_dim + 2 * m.v_head_dim),
                "all-reduce": 3 * act * D}
    if shape == "prefill_32k":  # k and v gathered for a group's key head; 3 sums as above
        return {"all-gather": 2 * act * kv, "all-reduce": 3 * act * D}
    # train: the k and v gathers again in the period's recompute; the sums
    # of the forward (3), wo's again in the recompute, the input gradients
    # of the logits, q, k, v, gate and up (6), the k and v gradients and
    # the loss's three row sums and mean. The parameters' gradient sums
    # (2.5% of the all-reduce at 1 layer) are left to the tolerance.
    return {"all-gather": 2 * 2 * act * kv,
            "all-reduce": act * (10 * D + 2 * kv) + 3 * B_l * S * 4 + 4}


def check(name: str, got: dict) -> list:
    """What in ``got`` (:func:`trace_cell`'s record) disagrees with the
    cell's pin, as lines; empty when all agree."""
    pin = PINS[name]
    want = reckoned(name) or pin["kinds"]
    out = []
    if not close(got["peak"], pin["peak"]):
        out.append(f"{name}: peak {got['peak']:,} B, pinned {pin['peak']:,}")
    for kind in sorted(set(got["kinds"]) | set(want)):
        a, b = got["kinds"].get(kind, 0), want.get(kind, 0)
        if not close(a, b):
            out.append(f"{name}: {kind} {a:,} B, expected {b:,}")
    for site in sorted(set(got["sites"]) | set(pin["sites"])):
        a, b = got["sites"].get(site, []), pin["sites"].get(site, [])
        if a != b:
            out.append(f"{name}: {site} issues {a}, pinned {b}")
    return out


# the records on torch 2.13 (CPU) and 2.11 (the H100's host) alike, printed by
# python -m repro_torch.launch.pins; "kinds" only where reckoned() has none
PINS = {
    "qwen3_0_6b.prefill_32k": {
        "peak": 23318054404,
        "sites": {
            "repro_torch/models/attention.py:_qkv": ["all-gather"],
            "repro_torch/models/attention.py:gqa_forward": ["all-reduce"],
            "repro_torch/models/common.py:apply_mlp": ["all-reduce"],
            "repro_torch/models/transformer.py:forward": ["all-reduce"],
        },
    },
    "qwen3_0_6b.train_4k": {
        "peak": 10789344048,
        "sites": {
            "repro_torch/models/attention.py:_qkv": ["all-gather"],
            "repro_torch/models/attention.py:gqa_forward": ["all-reduce"],
            "repro_torch/models/common.py:apply_mlp": ["all-reduce"],
            "repro_torch/models/transformer.py:forward": ["all-reduce"],
            "repro_torch/optim/adam.py:global_norm": ["all-reduce"],
            "repro_torch/runtime/steps.py:_value_and_grad": ["all-reduce"],
            "repro_torch/runtime/steps.py:_value_and_grad.<locals>.<lambda>": ["all-reduce"],
            "repro_torch/runtime/steps.py:cross_entropy": ["all-reduce"],
        },
    },
    "minicpm3_4b.prefill_32k": {
        "peak": 55824078852,
        "sites": {
            "repro_torch/models/attention.py:mla_forward": ["all-gather", "all-reduce"],
            "repro_torch/models/attention.py:mla_forward.<locals>.block": ["all-gather"],
            "repro_torch/models/common.py:apply_mlp": ["all-reduce"],
            "repro_torch/models/transformer.py:forward": ["all-reduce"],
        },
    },
    "xlstm_350m.prefill_128": {
        "peak": 349196028,
        "kinds": {"all-reduce": 3690496, "all-gather": 70811648},
        "sites": {
            "repro_torch/models/ssm.py:mlstm_forward": ["all-gather", "all-reduce"],
            "repro_torch/models/ssm.py:mlstm_forward.<locals>.heads": ["all-gather"],
            "repro_torch/models/ssm.py:slstm_forward": ["all-gather", "all-reduce"],
            "repro_torch/models/transformer.py:forward": ["all-reduce"],
        },
    },
    "psvgp.gather_4x4": {
        "peak": 119792,
        "sites": {
            "repro_torch/kernels/ref.py:minibatch_draws": ["all-gather"],
            "repro_torch/core/sampler.py:gather_minibatch": ["all-gather"],
            "repro_torch/launch/dryrun.py:psvgp_gather_trace": ["all-reduce"],
        },
    },
}


def main() -> None:
    """Print every cell's record, to read against :data:`PINS`."""
    import torch

    torch.set_num_threads(1)
    print(json.dumps({name: trace_cell(name) for name in CELLS}, indent=1))


if __name__ == "__main__":
    main()
