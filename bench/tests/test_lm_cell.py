"""The LM training cell, ``deepseek_v2_lite_ep8.train_4k_zipf``, on the CPU:
its configuration against the published one; ``counts_lm``'s FLOPs at the
published sizes, as ``PERF.md`` writes them term by term; a copy of the
cell at the smoke size through the harness, traced and not, with the
cell's own limits: sound, ``correct``; with each planted fault of
``faults_lm`` and with its control, not; the LM span readers on a traced
unit's records.
"""
from __future__ import annotations

import json
import os
import shutil

import pytest
from conftest import ROOT, run_tiny

from bench import counts, counts_lm, faults_lm, harness

CELL = "deepseek_v2_lite_ep8.train_4k_zipf"
SMOKE_CELL = "deepseek_v2_lite_smoke.train_smoke"
CATALOG = {  # the published config.json's numbers (hf:deepseek-ai/DeepSeek-V2-Lite)
    "first_k_dense_replace": 1, "hidden_size": 2048, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840, "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06, "rope_theta": 10000, "routed_scaling_factor": 1, "topk_group": 1,
    "v_head_dim": 128, "vocab_size": 102400}


def load_cfg() -> dict:
    with open(os.path.join(ROOT, "bench", "configs", "deepseek_v2_lite_ep8.json"),
              encoding="utf-8") as f:
        return json.load(f)


def test_the_configuration_is_the_published_one_but_what_it_reduces():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        m = json.load(f)
    entry = next(c for c in m["configs"] if c["name"] == "deepseek_v2_lite_ep8")
    cfg = load_cfg()
    changed = {k for k, v in CATALOG.items() if cfg[k] != v}
    assert changed == set(entry["reduced"]) == {"n_routed_experts", "vocab_size"}
    assert (cfg["n_routed_experts"], cfg["vocab_size"]) == (8, 12800)
    assert cfg["deployment"]["published"] == {"n_routed_experts": 64, "vocab_size": 102400}
    assert cfg["q_lora_rank"] is None and cfg["norm_topk_prob"] is False and cfg["seq_aux"]
    assert cfg["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                                   "mscale": 0.707, "mscale_all_dim": 0.707,
                                   "original_max_position_embeddings": 4096, "type": "yarn"}
    cell = next(w for w in m["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    lm = [x for x in m["per_layer"] if CELL in x.get("workloads", [])]
    assert {x["name"] for x in lm} == {"moe_experts_roofline", "moe_dispatch_ms",
                                       "mla_attention_ms", "adamw_roofline"}
    assert all(x["workloads"] == [CELL] for x in lm)


def test_the_step_flops_at_the_published_sizes():
    """PERF.md's table: F = 2,740,191,232 a token; 3F a token over 32,768
    tokens, 269.37 TFLOP a step."""
    terms = counts_lm.forward_terms(load_cfg(), 4096)
    assert terms == {"mla_projections": 27 * 2 * 13_762_560, "attention": 27 * 4096 * 16 * 320,
                     "router": 26 * 2 * 2048 * 64, "shared_experts": 26 * 6 * 2048 * 2816,
                     "held_experts": 26 * 6 * 2048 * 1408 * 6 * 8 // 64,
                     "dense_ffn": 6 * 2048 * 10944, "head": 2 * 2048 * 12800}
    assert sum(terms.values()) == 2_740_191_232
    assert counts_lm.step_flops(load_cfg(), 8, 4096) == 3 * 32768 * 2_740_191_232
    assert counts_lm.experts_flops(3072, {"d_model": 2048, "d_expert": 1408}) == \
        3072 * 6 * 2048 * 1408
    assert counts_lm.adamw_bytes(2_743_987_712) == 28 * 2_743_987_712


def smoke_copy(dst: str) -> str:
    """A copy of the benchmark with one more cell: the LM cell at the smoke
    size (``deepseek_v2_lite.smoke()``'s widths, 8 of 64 experts held, a
    256-id slice, float32), 2 x 24 tokens a step, the cell's own limits."""
    shutil.copytree(os.path.join(ROOT, "bench"), os.path.join(dst, "bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = load_cfg()
    cfg.update(name="deepseek_v2_lite_smoke", hidden_size=64, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
               moe_intermediate_size=32, vocab_size=256, dtype="float32")
    with open(os.path.join(ROOT, "bench", "traffic", "train_4k_zipf.json"),
              encoding="utf-8") as f:
        mix = json.load(f)
    mix.update(batch=2, seq_len=24)
    files = {"bench/configs/deepseek_v2_lite_smoke.json": cfg,
             "bench/traffic/train_smoke.json": mix}
    with open(os.path.join(ROOT, "bench", "limits", f"{CELL}.json"), encoding="utf-8") as f:
        files[f"bench/limits/{SMOKE_CELL}.json"] = json.load(f)
    for rel, body in files.items():
        with open(os.path.join(dst, rel), "w", encoding="utf-8") as f:
            json.dump(body, f)
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "deepseek_v2_lite_smoke", "source": "tests",
                                "reduced": [], "file": "bench/configs/deepseek_v2_lite_smoke.json",
                                "why": "a CPU pass"})
    manifest["workloads"].append({"name": SMOKE_CELL, "config": "deepseek_v2_lite_smoke",
                                  "traffic": "train_smoke", "chips": 1, "why": "a CPU pass"})
    for x in manifest["per_layer"]:
        if CELL in x.get("workloads", []):
            x["workloads"].append(SMOKE_CELL)
    with open(os.path.join(dst, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    return dst


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    return smoke_copy(str(tmp_path_factory.mktemp("lm_cell")))


@pytest.mark.parametrize("trace", [False, True])
def test_the_smoke_cell_runs_sound(smoke_root, trace):
    result = run_tiny(smoke_root, trace=trace, cell=SMOKE_CELL)
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["check"]["dropped"]["value"] == 0
    if trace:  # the host-timed steps read; the span readers need the card's events
        assert set(result["metrics"]) == {"replay_step_ms", "capture_ms"}
    else:
        assert set(result["metrics"]) == {"fit_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults_lm.FAULTS) + sorted(faults_lm.CONTROL))
def test_every_fault_flips_correct(smoke_root, fault):
    with {**faults_lm.FAULTS, **faults_lm.CONTROL}[fault]():
        result = run_tiny(smoke_root, cell=SMOKE_CELL)
    assert not result["correct"], result["check"]


def traced_records() -> dict:
    """A traced window of two one-step units, as the entry stores them: the
    program's spans with their CUDA events' ms and counters."""
    def unit(scale):
        spans = [{"name": "lm.train_step", "attrs": {}},
                 {"name": "mla.attention", "attrs": {"device_ms": 2.0 * scale}},
                 {"name": "moe.route", "attrs": {"device_ms": 0.5}},
                 {"name": "moe.dispatch", "attrs": {"device_ms": 1.0}},
                 {"name": "moe.experts", "attrs": {"device_ms": 4.0, "assignments": 24576,
                                                   "max_load": 2.0}},
                 {"name": "moe.combine", "attrs": {"device_ms": 0.5, "dropped": 0}},
                 {"name": "lm.adamw", "attrs": {"device_ms": 100.0,
                                                "elements": 2_743_987_712}}]
        return {"steps": 1, "wall_s": 1.2, "device_ms": 1100.0, "device_steps": 1,
                "trace": {"spans": spans, "dropped": 0}}

    return {"units": [unit(1.0), unit(2.0)], "platform": "gpu", "profile": None,
            "shape": {"d_model": 2048, "d_expert": 1408, "step_flops": 1, "peak": "bf16"},
            "window": {"seconds": 2.4, "steps": 2, "units": 2}, "setup_s": 20.0}


def read(name: str, records: dict):
    return harness.load_module(os.path.join(ROOT, "bench"), "metrics", name).read(records)


def test_the_lm_span_readers():
    r = traced_records()
    assert read("mla_attention_ms", r) == pytest.approx((2.0 + 4.0) / 2)
    assert read("moe_dispatch_ms", r) == pytest.approx(2.0)
    flops = 2 * 24576 * 6 * 2048 * 1408
    assert read("moe_experts_roofline", r) == pytest.approx(
        100 * flops / 8e-3 / counts.PEAK_BF16_FLOP_PER_S)
    assert read("adamw_roofline", r) == pytest.approx(
        100 * 2 * 28 * 2_743_987_712 / counts.PEAK_BYTES_PER_S / 0.2)
    untraced = dict(r, units=[{k: v for k, v in u.items() if k != "trace"} for u in r["units"]])
    off_card = dict(r, platform="cpu")
    for name in ("mla_attention_ms", "moe_dispatch_ms", "moe_experts_roofline",
                 "adamw_roofline"):
        assert read(name, untraced) is None
    assert read("moe_experts_roofline", off_card) is None
    assert read("adamw_roofline", off_card) is None
