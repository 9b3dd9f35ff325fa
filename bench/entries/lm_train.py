"""Entry ``lm_train``: an LM's pretraining steps through the program's own
train step (``runtime.steps.make_train_step(..., in_place=True)`` over
``models.transformer.forward``), the configuration's model as its file
states it (``model_config``).

Set-up draws the weights from the seed (the plain reference's own draws,
``bench/reference/<reference>.py:weight``, placed into the program's
parameter tree by :func:`port_params`) and takes one step, the shapes'
first call. A unit of the window is ``steps_per_unit`` steps on new
batches, then a synchronize. After it the check (:meth:`Run.check`) puts
the seed's weights back into the program's state and drives two steps on
the seed's first two batches, at the timed sizes, with the program's
tracer on to read its dropped-assignment counters; it keeps on the device
what it compares; then the program's moments are freed and the reference
follows the same two steps in float32, TF32 off.

A batch is ``batch`` sequences of ``seq_len`` + 1 token ids, i.i.d. from a
Zipf law of exponent ``zipf_exponent`` over the configuration's vocabulary
(the chip's slice), ranks permuted by the seed; the tokens are its first
``seq_len`` columns, the targets its last. Made on the device.

With ``--trace 1`` each unit's steps run between CUDA events (``device_ms``
over ``device_steps``) with the program's tracer on, and its spans, summed
by name (:func:`by_name`), go in the unit's ``trace``; ``profile()`` runs
``profile_steps`` more steps under ``torch.profiler``. The run's ``shape``
reports the step's FLOPs (``counts_lm.step_flops``), the BF16 peak and the
sizes the span readers need.
"""
from __future__ import annotations

import contextlib
import importlib
import math
import time

import torch

from bench import counts_lm, profiles
from bench.seeds import sub_seed

GROUPS = ("mla", "router", "shared", "held_experts", "dense_ffn", "embed", "head")
_MLA = {"attn_norm": ("ln1",), "q": ("mix", "w_q"), "dkv": ("mix", "w_dkv"),
        "kv_norm": ("mix", "kv_norm"), "kr": ("mix", "w_kr"), "uk": ("mix", "w_uk"),
        "uv": ("mix", "w_uv"), "o": ("mix", "wo")}
_FFN = {"gate": "w_gate", "up": "w_up", "down": "w_down"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ the model

def model_config(hf: dict):
    """The program's configuration of the model ``hf`` states: DeepSeek-V2's
    MLA without q LoRA, YaRN, and its expert layer as the deployment gives
    this chip its share."""
    from repro_torch.models.config import (
        HeldMoEConfig,
        MLAConfig,
        ScaledRopeModelConfig,
        YaRNConfig,
    )

    dep, y = hf["deployment"], hf["rope_scaling"]
    assert hf["first_k_dense_replace"] == 1 and hf["moe_layer_freq"] == 1, hf
    assert hf["hidden_act"] == "silu" and not hf["tie_word_embeddings"], hf
    assert hf["scoring_func"] == "softmax" and hf["topk_method"] == "greedy", hf
    assert hf["num_key_value_heads"] == hf["num_attention_heads"] and y["type"] == "yarn", hf
    return ScaledRopeModelConfig(
        name=hf["arch"], arch_type="moe", num_layers=hf["num_hidden_layers"],
        d_model=hf["hidden_size"], num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"], d_ff=hf["moe_intermediate_size"],
        vocab_size=hf["vocab_size"], block_pattern=("mla",), rope_theta=float(hf["rope_theta"]),
        norm_eps=hf["rms_norm_eps"], dtype=hf["dtype"],
        moe=HeldMoEConfig(
            num_experts=dep["router_experts"], top_k=hf["num_experts_per_tok"],
            d_expert=hf["moe_intermediate_size"], num_shared=hf["n_shared_experts"],
            router_aux_weight=hf["aux_loss_alpha"], first_layer_dense=True,
            dense_d_ff=hf["intermediate_size"], norm_topk_prob=hf["norm_topk_prob"],
            routed_scaling_factor=float(hf["routed_scaling_factor"]), seq_aux=hf["seq_aux"],
            router_fp32=True, dropless=True, experts_first=dep["experts_first"],
            experts_held=hf["n_routed_experts"]),
        mla=MLAConfig(q_lora_rank=hf["q_lora_rank"] or 0, kv_lora_rank=hf["kv_lora_rank"],
                      qk_nope_head_dim=hf["qk_nope_head_dim"],
                      qk_rope_head_dim=hf["qk_rope_head_dim"], v_head_dim=hf["v_head_dim"]),
        rope_scaling=YaRNConfig(
            factor=float(y["factor"]), original_max_position=y["original_max_position_embeddings"],
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale=float(y["mscale"]), mscale_all_dim=float(y["mscale_all_dim"])),
        rope_interleave=True, attn_sdpa=True,
        citation="bench/configs").validate()


def place(name: str, e0: int = 0) -> tuple[tuple, tuple]:
    """A reference weight's place in the program's tree: (key path, index
    into the leaf). Layer 0 is the dense ``prelude``; layer i > 0 is row
    i - 1 of the period stack; a held expert e its row e - e0."""
    if name in ("embed", "lm_head", "final_norm"):
        return (name,), ()
    parts = name.split(".")
    i, rest = int(parts[1]), parts[2:]
    base, index = (("prelude",), ()) if i == 0 else (("stack", "b0"), (i - 1,))
    if rest[0] in _MLA:
        return base + _MLA[rest[0]], index
    if rest[0] == "ffn_norm":
        return base + ("ln2",), index
    if rest[0] == "mlp":
        return base + ("mlp", _FFN[rest[1]]), index
    if rest[0] == "router":
        return base + ("moe", "router"), index
    if rest[0] == "shared":
        return base + ("moe", "shared", _FFN[rest[1]]), index
    assert rest[0] == "experts", name
    return base + ("moe", _FFN[rest[2]]), index + (int(rest[1]) - e0,)


def group(name: str) -> str:
    """The leaf group a reference weight's gradient is compared in; a norm
    goes with the block it feeds."""
    if name == "embed":
        return "embed"
    if name in ("lm_head", "final_norm"):
        return "head"
    rest = name.split(".")[2]
    if rest in _MLA:
        return "mla"
    if rest == "mlp" or (rest == "ffn_norm" and name.startswith("layers.0.")):
        return "dense_ffn"
    if rest in ("router", "ffn_norm"):
        return "router"
    return {"shared": "shared", "experts": "held_experts"}[rest]


def leaf(tree: dict, path: tuple, index: tuple) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree[index] if index else tree


def port_params(hf: dict, seed: int, device: torch.device) -> dict:
    """The program's parameter tree (``transformer.init_model_params``'s
    keys and shapes: a dense ``prelude``, the MoE layers stacked under
    ``stack/b0``, an empty ``remainder``) holding the reference's weights
    of ``seed``, each drawn and copied into its place."""
    ref = importlib.import_module(f"bench.reference.{hf['reference']}")
    e0, held, stacked = (hf["deployment"]["experts_first"], hf["n_routed_experts"],
                         hf["num_hidden_layers"] - 1)
    shapes = ref.leaf_shapes(hf)
    params: dict = {"remainder": []}
    for name, (shape, _) in shapes.items():
        path, index = place(name, e0)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path[-1] not in node:
            lead = (stacked, held)[:len(index)]
            node[path[-1]] = torch.empty(lead + tuple(shape), dtype=torch.float32, device=device)
    for name, (shape, init) in shapes.items():
        leaf(params, *place(name, e0)).copy_(ref.weight(seed, name, shape, init, device))
    return params


@contextlib.contextmanager
def first_expert_layer(on: bool):
    """Within it (when ``on``), the first call of the program's held experts
    (``moe.held_experts``: the first expert layer's forward) is read where
    it computes, into the dict it yields: its input rows, their segments'
    counts and its outputs."""
    from repro_torch.models import moe

    captured: dict = {}
    if not on:
        yield captured
        return
    experts = moe.held_experts

    def held_experts(rows, counts, p, dt):
        y = experts(rows, counts, p, dt)
        captured.setdefault("call", (rows.detach(), list(counts), y.detach()))
        return y

    moe.held_experts = held_experts
    try:
        yield captured
    finally:
        moe.held_experts = experts


def by_name(drained: dict) -> dict:
    """A unit's drained spans summed by name, so that its record (which the
    result line carries) stays a few lines: one span a name, its counters
    and ``device_ms`` summed (``max_load`` the largest), ``count`` the spans."""
    out: dict[str, dict] = {}
    for sp in drained["spans"]:
        acc = out.setdefault(sp["name"], {"count": 0})
        acc["count"] += 1
        for k, v in sp["attrs"].items():
            if v is None:
                continue
            acc[k] = max(acc.get(k, v), v) if k == "max_load" else acc.get(k, 0) + v
    return {"spans": [{"name": k, "attrs": v} for k, v in out.items()],
            "dropped": drained["dropped"]}


# ------------------------------------------------------------ the traffic

def batch(mix: dict, vocab: int, seed: int, k: int, device: torch.device):
    """Batch ``k`` of the run: (tokens (B, S), targets (B, S)), int64."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "zipf:ranks"))
    ranks = torch.randperm(vocab, generator=gen, device=device)
    law = torch.arange(1, vocab + 1, dtype=torch.float64, device=device).pow(
        -float(mix["zipf_exponent"]))
    gen.manual_seed(sub_seed(seed, f"batch:{k}"))
    B, S = int(mix["batch"]), int(mix["seq_len"])
    ids = ranks[torch.multinomial(law.float(), B * (S + 1), replacement=True,
                                  generator=gen)].reshape(B, S + 1)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


# ------------------------------------------------------------ the run

class Run:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: torch.device):
        from repro_torch import trace
        from repro_torch.optim.adam import adam_init
        from repro_torch.runtime import steps

        self.trace, self.hf, self.mix, self.seed, self.device = trace, cfg, mix, seed, device
        self.setup_phases: dict[str, float] = {}
        mark = [time.perf_counter()]

        def lap(name: str) -> None:
            now = time.perf_counter()
            self.setup_phases[name], mark[0] = now - mark[0], now

        self.cfg = model_config(cfg)
        self.opt = cfg["optimizer"]
        if device.type == "cuda":  # the peak from here on is the program's
            torch.zeros((), device=device)  # the card's context, before its counters
            torch.cuda.reset_peak_memory_stats(device)
        lap("card")
        self.params = port_params(cfg, seed, device)
        self.state = steps.TrainState(self.params, adam_init(self.params), 0)
        self.step_fn = steps.make_train_step(self.cfg, learning_rate=self.opt["lr"],
                                             clip_norm=self.opt["clip"], in_place=True)
        B, S = int(mix["batch"]), int(mix["seq_len"])
        self.shape = {"batch": B, "seq_len": S, "d_model": cfg["hidden_size"],
                      "d_expert": cfg["moe_intermediate_size"],
                      "step_flops": counts_lm.step_flops(cfg, B, S), "peak": cfg["peak"]}
        lap("weights")
        self.steps = int(limits["steps"])
        self.check_batches = [batch(mix, cfg["vocab_size"], seed, k, device)
                              for k in range(self.steps)]
        self.losses: list[torch.Tensor] = [self._step(-1)]  # the shapes' first call
        sync(device)
        lap("warm_up")
        self.timing = False

    def _step(self, k: int) -> torch.Tensor:
        tokens, targets = batch(self.mix, self.hf["vocab_size"], self.seed, k, self.device)
        self.state, metrics = self.step_fn(self.state, {"tokens": tokens, "targets": targets})
        return metrics["loss"]

    # ------------------------------------------------------------ the check's drive

    def reset(self) -> None:
        """The program's state back to the seed's weights, zero moments and
        step 0, in place (the calibration drives it again, with a fault)."""
        from repro_torch.optim.adam import tree_leaves

        ref = importlib.import_module(f"bench.reference.{self.hf['reference']}")
        e0 = self.hf["deployment"]["experts_first"]
        for name, (shape, init) in ref.leaf_shapes(self.hf).items():
            leaf(self.state.params, *place(name, e0)).copy_(
                ref.weight(self.seed, name, shape, init, self.device))
        for t in tree_leaves((self.state.opt.mu, self.state.opt.nu)):
            t.zero_()
        self.state = self.state._replace(step=0, opt=self.state.opt._replace(step=0))

    def drive(self) -> dict:
        """The check's steps from the state :meth:`reset` left, the tracer on
        (its dropped-assignment counters). Kept on the device, by the
        reference's weight names: the first gradient as the optimizer got
        it (AdamW's first moment over 1 - b1), the first expert layer's held
        experts' input rows and outputs on the first batch, and the change
        of every weight over the steps, written over the state's parameters
        (:meth:`reset` restores them)."""
        ref = importlib.import_module(f"bench.reference.{self.hf['reference']}")
        e0, b1 = self.hf["deployment"]["experts_first"], self.opt["b1"]
        names = ref.leaf_shapes(self.hf)
        trace = self.trace
        trace.set_enabled(True)
        try:
            for k, (tokens, targets) in enumerate(self.check_batches):
                with first_expert_layer(k == 0) as captured:
                    self.state, metrics = self.step_fn(self.state,
                                                       {"tokens": tokens, "targets": targets})
                if k == 0:
                    loss1 = float(metrics["loss"])
                    mu = self.state.opt.mu
                    grad1 = {n: leaf(mu, *place(n, e0)) / (1.0 - b1) for n in names}
                    rows, counts, y = captured["call"]
                    experts1 = {"rows": rows, "counts": counts, "y": y}
            sync(self.device)
        finally:
            trace.set_enabled(False)
        spans = trace.drain()["spans"]
        dropped = sum(s["attrs"].get("dropped", 0) for s in spans if s["name"] == "moe.combine")
        change = {}
        for n, (shape, init) in names.items():
            change[n] = leaf(self.state.params, *place(n, e0))
            change[n].sub_(ref.weight(self.seed, n, shape, init, self.device))
        return {"loss1": loss1, "grad1": grad1, "change": change, "dropped": dropped,
                "experts1": experts1}

    # ------------------------------------------------------------ the window

    def unit(self, k: int) -> dict:
        n = int(self.mix["steps_per_unit"])
        first = self.steps + k * n
        events = None
        if self.timing and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        if events:
            events[0].record()
        for j in range(n):
            self.losses.append(self._step(first + j))
        if events:
            events[1].record()
        sync(self.device)
        record = {"steps": n, "wall_s": time.perf_counter() - t0, "loss": float(self.losses[-1])}
        if self.timing:
            record["device_ms"] = (events[0].elapsed_time(events[1]) if events
                                   else 1e3 * record["wall_s"])
            record["device_steps"] = n
            record["trace"] = by_name(self.trace.drain())
        return record

    @contextlib.contextmanager
    def timed_units(self):
        """Within it every unit's steps are timed by CUDA events and traced."""
        self.timing = True
        self.trace.drain()
        self.trace.set_enabled(True)
        try:
            yield
        finally:
            self.trace.set_enabled(False)
            self.timing = False

    def profile(self) -> dict | None:
        n = int(self.mix["profile_steps"])
        first = self.steps + 10**6
        self._step(first)  # off the window's batches, and warm under the profiler's hooks
        sync(self.device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for j in range(n):
                self._step(first + 1 + j)
            sync(self.device)
            window_s = time.perf_counter() - t0
        return profiles.reduce(prof, window_s, n)

    def failed_units(self) -> int:
        """Steps whose loss is not finite, or 1 where a parameter is not."""
        from repro_torch.optim.adam import tree_leaves

        bad = sum(int(not math.isfinite(float(v))) for v in self.losses)
        params = tree_leaves(self.state.params)
        return bad + (0 if bool(torch.stack([torch.isfinite(a).all() for a in params]).all())
                      else 1)

    # ------------------------------------------------------------ after the window

    def release(self) -> None:
        """Nothing to free yet: the check drives the program's own state
        again from the seed's weights (what the window left is overwritten)."""
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict[str, float]:
        """The check's steps through the program, then, the program's
        moments freed (its parameters hold the change), the reference's."""
        ref = importlib.import_module(f"bench.reference.{self.hf['reference']}")
        self.reset()
        program = self.drive()
        self.state = self.params = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        gaps = Gaps(program, self.device, ref)
        return gaps.numbers(follow(ref, self.hf, self.seed, self.check_batches, self.device,
                                   gaps.visit))


def follow(ref, hf: dict, seed: int, batches, device: torch.device, visit) -> float:
    """The reference's steps from the seed's weights on the check's
    batches, in float32; ``visit(kind, name, value)`` sees, on the device,
    the first expert layer's held experts' weights (kind "experts1", name
    the held expert's index, value its "gate", "up" and "down"), then each
    weight's first (clipped) gradient ("grad1") and its change over the
    steps ("change"). Returns the first step's loss."""
    w = ref.weights(hf, seed, device)
    e0, a = hf["deployment"]["experts_first"], f"layers.{hf['first_k_dense_replace']}.experts."
    for e in range(hf["n_routed_experts"]):
        visit("experts1", e, {k: w[f"{a}{e0 + e}.{k}"] for k in ("gate", "up", "down")})

    def on_grad(t: int, grads: dict) -> None:
        if t == 1:
            for name, g in grads.items():
                visit("grad1", name, g)

    losses = ref.train_steps(w, batches, hf, hf["optimizer"], on_grad)
    for name, (shape, init) in ref.leaf_shapes(hf).items():
        visit("change", name, w[name] - ref.weight(seed, name, shape, init, device))
    return losses[0]


class Gaps:
    """The check's numbers for what the program kept (``program``, from
    :meth:`Run.drive`), visited by the reference's values one by one
    (:func:`follow`): per leaf group the relative L2 gap of the first
    gradients, sqrt(sum |prog - ref|^2 / sum |ref|^2); the same of the
    change over every weight; the same of the first expert layer's held
    experts' outputs against the reference's experts (``ref.ffn``) on the
    same input rows, the program's own (so the routing, which rounding
    decides at a near tie, is out of it: it weighs in the gradients); the
    first loss's relative gap."""

    def __init__(self, program: dict, device: torch.device, ref):
        self.program, self.device, self.ref = program, device, ref
        self.sums = {g: [0.0, 0.0] for g in GROUPS + ("change", "experts1")}

    def _acc(self, key: str, prog: torch.Tensor, ref: torch.Tensor) -> None:
        self.sums[key][0] += float(torch.sum((prog.double() - ref.double()) ** 2))
        self.sums[key][1] += float(torch.sum(ref.double() ** 2))

    def visit(self, kind: str, name, value) -> None:
        if kind == "experts1":
            mine = self.program["experts1"]
            start = sum(mine["counts"][:name])
            sl = slice(start, start + mine["counts"][name])
            rows = mine["rows"][sl].to(self.device, torch.float32)
            with torch.no_grad():
                self._acc("experts1", mine["y"][sl].to(self.device), self.ref.ffn(value, "", rows))
            return
        key = group(name) if kind == "grad1" else "change"
        self._acc(key, self.program[kind][name].to(self.device), value)

    def numbers(self, ref_loss1: float) -> dict[str, float]:
        def gap(key):
            num, den = self.sums[key]
            return math.sqrt(num / den) if den else 1.0  # nothing to compare: nothing agrees

        out = {"loss1_gap": abs(self.program["loss1"] - ref_loss1) / abs(ref_loss1)}
        out.update({f"grad1_gap.{g}": gap(g) for g in GROUPS})
        out["grad1_gap"] = max(out[f"grad1_gap.{g}"] for g in GROUPS)
        out["change_gap"] = gap("change")
        out["experts1_gap"] = gap("experts1")
        out["dropped"] = float(self.program["dropped"])
        return out


def setup(cfg: dict, mix: dict, limits: dict, seed: int, device: torch.device) -> Run:
    return Run(cfg, mix, limits, seed, device)
