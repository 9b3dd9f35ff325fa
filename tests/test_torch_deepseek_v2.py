"""DeepSeek-V2-Lite in the port (``configs/deepseek_v2_lite.py``, port-only)
against its plain float32 reference (``tests/reference/deepseek_v2.py``),
on seeded random weights at the smoke size on the CPU.

The port runs the model through its normal path (``transformer.forward``,
``runtime.steps.make_train_step``) in float32, so every tolerance below is
float32 rounding in a different op order (the port's fused attention, its
grouped expert products and float32 combine, against the reference's
explicit softmax and per-expert loops), never a difference of mathematics:
a fault in routing, gating, scaling or dispatch moves these numbers by
1e-2 or more (``bench/tests/test_lm_cell.py``).

Also: YaRN's frequencies and scale at the published sizes; the gates
unnormalised and the sequence-wise balance loss; no assignment dropped
under a routing skewed onto the held experts; the eight shares of the
expert layer adding up to the uncut layer; the in-place clip and AdamW
bitwise the out-of-place ones; the CLI.
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from reference import deepseek_v2 as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench.entries import lm_train  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.common import yarn_correction_range, yarn_inv_freq  # noqa: E402
from repro_torch.optim.adam import (  # noqa: E402
    AdamState,
    adam_init,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    clip_by_global_norm_,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import steps  # noqa: E402

SEED = 2**31 + 77
FP32_RTOL = 2e-5  # float32 rounding in another op order, relative to a tensor's norm
CELL_CONFIG = os.path.join(ROOT, "bench", "configs", "deepseek_v2_lite_ep8.json")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def smoke_hf(held: int = 8, first: int = 0, vocab: int = 256) -> dict:
    """The cell's configuration file at the smoke size (``deepseek_v2_lite.
    smoke()``'s), holding experts [first, first + held) of 64."""
    with open(CELL_CONFIG, encoding="utf-8") as f:
        hf = json.load(f)
    cfg = configs.get_smoke("deepseek-v2-lite")
    hf.update(hidden_size=cfg.d_model, num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
              kv_lora_rank=cfg.mla.kv_lora_rank, qk_nope_head_dim=cfg.mla.qk_nope_head_dim,
              qk_rope_head_dim=cfg.mla.qk_rope_head_dim, v_head_dim=cfg.mla.v_head_dim,
              intermediate_size=cfg.moe.dense_d_ff, moe_intermediate_size=cfg.moe.d_expert,
              n_routed_experts=held, vocab_size=vocab, dtype="float32", name="smoke")
    hf["deployment"] = dict(hf["deployment"], experts_first=first)
    return hf


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def tokens(hf: dict, B: int = 2, S: int = 24, k: int = 0):
    mix = {"batch": B, "seq_len": S, "zipf_exponent": 1.0}
    return lm_train.batch(mix, hf["vocab_size"], SEED, k, torch.device("cpu"))


def port(hf: dict):
    return lm_train.model_config(hf), lm_train.port_params(hf, SEED, torch.device("cpu"))


# ------------------------------------------------------------ the configuration


def test_reference_is_the_benchmarks_copy():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "reference", "deepseek_v2.py"),
                       os.path.join(ROOT, "bench", "reference", "deepseek_v2.py"), shallow=False)


def test_registry_resolves_the_port_only_ids():
    assert configs.PORT_ARCH_IDS == ["deepseek_v2_lite", "deepseek_v2_lite_ep8"]
    assert not set(configs.PORT_ARCH_IDS) & set(configs.ARCH_IDS)
    full, cut = configs.get("deepseek-v2-lite"), configs.get("deepseek-v2-lite-ep8")
    assert (full.moe.held, full.vocab_size) == (64, 102400)
    assert (cut.moe.num_experts, cut.moe.held, cut.moe.experts_first, cut.vocab_size) == \
        (64, 8, 0, 12800)
    assert (cut.num_layers, cut.d_model, cut.moe.top_k, cut.moe.d_expert) == (27, 2048, 6, 1408)
    smoke = configs.get_smoke("deepseek-v2-lite-ep8")
    assert (smoke.moe.num_experts, smoke.moe.held, smoke.moe.top_k) == (64, 8, 6)


def test_the_cells_file_is_the_registered_cut():
    with open(CELL_CONFIG, encoding="utf-8") as f:
        hf = json.load(f)
    want = dataclasses.replace(configs.get("deepseek-v2-lite-ep8"), citation="bench/configs")
    assert lm_train.model_config(hf) == want


def test_the_benchmarks_tree_is_the_programs():
    """``lm_train.port_params`` builds the tree ``init_model_params`` does:
    the same keys, shapes and dtypes, every leaf set."""
    hf = smoke_hf()
    cfg, built = port(hf)
    want = transformer.init_model_params(torch.Generator().manual_seed(0), cfg)
    assert tree_map(lambda a: (tuple(a.shape), a.dtype), built) == \
        tree_map(lambda a: (tuple(a.shape), a.dtype), want)
    w = ref.weights(hf, SEED)
    assert sum(a.numel() for a in tree_leaves(built)) == sum(v.numel() for v in w.values())


def test_parameters_held_by_the_cut():
    """2,744 M: the embedding and head slices 52.4 M, MLA 13.76 M a layer,
    the dense FFN 67.2 M, each MoE layer 86.6 M."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = transformer.init_model_params(torch.Generator(),
                                               configs.get("deepseek-v2-lite-ep8"))
    n = sum(a.numel() for a in tree_leaves(params))
    assert n == 2_743_987_712
    assert sum(a.numel() for a in tree_leaves(params["stack"]["b0"]["moe"])) / 26 == 86_638_592
    assert sum(a.numel() for a in tree_leaves(params["prelude"]["mix"])) == 13_763_072


def test_yarn_at_the_published_sizes():
    """low = floor(c(32)) = 10, high = ceil(c(1)) = 23 over d = 64, b = 10,000;
    the softmax scale 192^-1/2 * mscale(40, 0.707)^2 = 0.114721."""
    from repro_torch.models.attention import mla_softmax_scale

    cfg = configs.get("deepseek-v2-lite")
    with open(CELL_CONFIG, encoding="utf-8") as f:
        hf = json.load(f)
    assert yarn_correction_range(64, 10000.0, cfg.rope_scaling) == (10, 23)
    assert ref.yarn_find_correction_range(32, 1, 64, 10000, 4096) == (10, 23)
    assert mla_softmax_scale(cfg) == pytest.approx(0.114721, abs=5e-7)
    assert ref.softmax_scale(hf) == pytest.approx(0.114721, abs=5e-7)
    base = 1.0 / 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    got = yarn_inv_freq(base, 64, 10000.0, cfg.rope_scaling)
    want = ref.inv_freq(hf)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)  # the published code's, rounding apart
    assert torch.equal(got[:10], base[:10]) and torch.allclose(got[23:], base[23:] / 40)


def test_the_references_chunked_attention():
    """``CHUNK`` query rows at a time against the keys up to the last: the
    whole masked softmax, within float32 rounding."""
    g = torch.Generator().manual_seed(9)
    q, k = torch.randn(2, 4, 24, 12, generator=g), torch.randn(2, 4, 24, 12, generator=g)
    v = torch.randn(2, 4, 24, 5, generator=g)
    scores = (q @ k.transpose(-1, -2)) * 0.3
    scores = scores.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), float("-inf"))
    want = torch.softmax(scores, -1) @ v
    for chunk in (5, 8, 24, 1024):
        assert rel(ref.causal_attention(q, k, v, 0.3, chunk), want) < 1e-6


# ------------------------------------------------------------ forward, gradients, steps


def test_forward_logits_and_loss():
    hf = smoke_hf()
    cfg, params = port(hf)
    toks, targets = tokens(hf)
    logits, _, aux = transformer.forward(params, cfg, toks)
    w = ref.weights(hf, SEED)
    want, _ = ref.forward(w, toks, hf)
    for b in range(toks.shape[0]):
        assert rel(logits[b], want[b]) < FP32_RTOL
    loss, _, _ = steps._loss_fn(params, cfg, {"tokens": toks, "targets": targets})
    assert float(loss) == pytest.approx(float(ref.loss(w, toks, targets, hf)), rel=1e-6)


def test_first_step_gradient_of_every_leaf():
    hf = smoke_hf()
    cfg, params = port(hf)
    toks, targets = tokens(hf)
    (loss, _, _), grads = steps._value_and_grad(params, cfg, {"tokens": toks,
                                                              "targets": targets})
    value, want = ref.grads(ref.weights(hf, SEED), toks, targets, hf)
    assert float(loss) == pytest.approx(float(value), rel=1e-6)
    e0 = hf["deployment"]["experts_first"]
    for name, g in want.items():
        got = lm_train.leaf(grads, *lm_train.place(name, e0))
        assert rel(got, g) < 1e-4, name  # a small leaf's gradient: rounding of a short sum


def test_two_train_steps():
    """The check's numbers on the CPU, float32 both sides: every gradient
    group and the loss within float32 rounding; the two steps' change,
    AdamW's first steps near sign(g), within the few signs that rounding
    flips on gradients nought to rounding."""
    hf = smoke_hf()
    run = lm_train.setup(hf, {"batch": 2, "seq_len": 24, "zipf_exponent": 1.0,
                              "steps_per_unit": 1, "profile_steps": 1},
                         {"steps": 2}, SEED, torch.device("cpu"))
    run.release()
    n = run.check()
    assert n["loss1_gap"] < 1e-6 and n["grad1_gap"] < 1e-4 and n["dropped"] == 0, n
    assert n["experts1_gap"] < 1e-5, n  # the same rows through the same float32 products
    assert n["change_gap"] < 1e-2, n


# ------------------------------------------------------------ the expert layer


def test_gates_unnormalised_and_the_sequence_wise_balance_loss():
    hf = smoke_hf()
    cfg, params = port(hf)
    p = params["stack"]["b0"]["moe"]
    lp = {k: (v[0] if k != "shared" else None) for k, v in p.items()}
    x = torch.randn(2 * 24, hf["hidden_size"], generator=torch.Generator().manual_seed(3))
    probs, gates, ids, aux = moe.route(lp, cfg, x, batch=2)
    assert torch.allclose(gates, torch.gather(probs, 1, ids))  # the raw probabilities
    assert float(gates.sum(-1).max()) < 0.9
    w = ref.weights(hf, SEED)
    _, g_ref, ids_ref, aux_sum = ref.route(w, "layers.1.", x.reshape(2, 24, -1), hf)
    assert torch.equal(ids.sort(-1).values, ids_ref.reshape(48, -1).sort(-1).values)
    assert torch.allclose(gates.sort(-1).values, g_ref.reshape(48, -1).sort(-1).values,
                          rtol=1e-5)
    assert float(aux) == pytest.approx(float(aux_sum) / 2, rel=1e-5)  # the sequences' mean
    # hand count: f_be = count_be / (S K / E), aux = mean_b sum_e f_be mean_s p_bse
    K, E = cfg.moe.top_k, cfg.moe.num_experts
    hand = 0.0
    for b in range(2):
        rows = slice(b * 24, (b + 1) * 24)
        counts = torch.bincount(ids[rows].reshape(-1), minlength=E).double()
        hand += float(torch.sum(counts / (24 * K / E) * probs[rows].double().mean(0))) / 2
    assert float(aux) == pytest.approx(hand, rel=1e-5)


def _layer_routed(first: int, x: torch.Tensor) -> torch.Tensor:
    """The port's first expert layer holding experts [first, first + 8),
    without its shared experts (the routed part), on x (1, T, D)."""
    cfg, params = port(smoke_hf(8, first))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared=0))
    p = {k: v[0] for k, v in params["stack"]["b0"]["moe"].items() if k != "shared"}
    return moe.moe_forward(p, cfg, x)[0]


def test_the_eight_shares_add_up_to_the_uncut_layer():
    """Experts 0-7, 8-15, ..., 56-63: each share's routed part from the
    port, plus the shared experts once, is the uncut reference's layer."""
    x = torch.randn(1, 40, 64, generator=torch.Generator().manual_seed(5))
    total = sum(_layer_routed(first, x) for first in range(0, 64, 8))
    hf = smoke_hf(64, 0)
    w = ref.weights(hf, SEED)
    want, _ = ref.moe(w, "layers.1.", x, hf)
    shared = ref.ffn(w, "layers.1.shared.", x)
    assert rel(total + shared, want) < FP32_RTOL


def test_no_assignment_dropped_under_a_skewed_routing():
    """A router that sends every token to experts 0-5, all held here: each
    gets T assignments (GShard's capacity int(1.25 T K / E) would keep 5 of
    40); the layer computes them all, its counters say so, and the
    reference agrees."""
    from repro_torch import trace

    T, hf = 40, smoke_hf()
    cfg, params = port(hf)
    p = tree_map(lambda a: a[0].clone(), params["stack"]["b0"]["moe"])
    x = torch.randn(1, T, 64, generator=torch.Generator().manual_seed(6))
    x[..., 0] = 10.0  # one input dim the router reads strongly: logits 3 * (6 - e) on 0-5
    p["router"] = p["router"] * 0.01
    p["router"][0] = torch.cat([torch.arange(6, 0, -1) * 0.3, torch.full((58,), -3.0)])
    trace.set_enabled(True)
    try:
        out, _ = moe.moe_forward(p, cfg, x)
    finally:
        trace.set_enabled(False)
    spans = {s["name"]: s["attrs"] for s in trace.drain()["spans"]}
    assert spans["moe.experts"]["assignments"] == 6 * T
    assert float(spans["moe.combine"]["dropped"]) == 0
    assert float(spans["moe.experts"]["max_load"]) == pytest.approx(T / (6 * T / 8))
    w = ref.weights(hf, SEED)
    w["layers.1.router"] = p["router"].clone()
    want, _ = ref.moe(w, "layers.1.", x, hf)
    assert rel(out, want) < FP32_RTOL


# ------------------------------------------------------------ the in-place optimizer


def test_in_place_clip_and_adamw_are_bitwise_the_out_of_place_ones():
    gen = torch.Generator().manual_seed(11)
    cfg = configs.get_smoke("deepseek-v2-lite-ep8")
    params = transformer.init_model_params(gen, cfg)
    grads = tree_map(lambda a: torch.randn(a.shape, generator=gen) * 3, params)
    state = AdamState(4, tree_map(lambda a: torch.randn(a.shape, generator=gen) * 0.1, params),
                      tree_map(lambda a: torch.rand(a.shape, generator=gen) * 0.1, params))
    clipped = clip_by_global_norm(grads, 1.0)
    want_p, want_s = adamw_update(params, clipped, state, lr=4.2e-4)
    p2, g2 = tree_map(torch.clone, params), tree_map(torch.clone, grads)
    s2 = AdamState(4, tree_map(torch.clone, state.mu), tree_map(torch.clone, state.nu))
    got_g = clip_by_global_norm_(g2, 1.0)
    got_p, got_s = adamw_update_(p2, got_g, s2, lr=4.2e-4)
    assert got_p is p2 and got_s.mu is s2.mu and got_s.step == 5
    for a, b in zip(tree_leaves((want_p, want_s.mu, want_s.nu, clipped)),
                    tree_leaves((got_p, got_s.mu, got_s.nu, got_g)), strict=True):
        assert torch.equal(a, b)


def test_the_in_place_train_step_is_bitwise_the_step():
    cfg = configs.get_smoke("deepseek-v2-lite-ep8")
    state = steps.init_train_state(torch.Generator().manual_seed(2), cfg)
    copy = steps.TrainState(tree_map(torch.clone, state.params),
                            adam_init(state.params), 0)
    hf = smoke_hf(vocab=cfg.vocab_size)
    for k in range(2):
        toks, targets = tokens(hf, k=k)
        batch = {"tokens": toks, "targets": targets}
        state, m1 = steps.make_train_step(cfg, 4.2e-4)(state, batch)
        copy, m2 = steps.make_train_step(cfg, 4.2e-4, in_place=True)(copy, batch)
        assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tree_leaves((state.params, state.opt.mu, state.opt.nu)),
                    tree_leaves((copy.params, copy.opt.mu, copy.opt.nu)), strict=True):
        assert torch.equal(a, b)


def test_the_train_cli_runs_the_smoke_model():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "deepseek-v2-lite", "--smoke", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--log-every", "1", "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), out.stdout
