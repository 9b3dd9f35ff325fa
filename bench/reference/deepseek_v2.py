"""DeepSeek-V2(-Lite) in plain float32 PyTorch: the plain reference of the
port's ``deepseek-v2-lite`` configurations, for tests and for the check
that decides a benchmark run's ``correct``.

Written from the published description (arXiv:2405.04434 and the model's
``modeling_deepseek.py`` on the Hugging Face hub) and from nothing of the
port: it imports no module of it, no kernel, no JAX. ``GROUP`` sequences
at a time, each attending within itself, no cache, every product in
float32 (the caller turns TF32 off on a GPU).

The configuration is a dict with the published ``config.json``'s keys
(``hidden_size``, ``num_hidden_layers``, ``kv_lora_rank``, ``rope_scaling``,
``n_routed_experts``, ...) and the deployment's under ``"deployment"``: a
chip of an expert-parallel deployment holds experts [``experts_first``,
``experts_first + n_routed_experts``) of ``router_experts`` (the router's
width) and the vocabulary slice of ``vocab_size`` ids, whose logits and
loss are over the slice. Absent, the chip holds every expert.

A layer, with x (S, D) its input:

* attention (MLA, ``q_lora_rank`` null): q = h W_q (H heads of dn + dr),
  c = RMSNorm(h W_dkv), k_nope = c W_uk, v = c W_uv, k_pe = h W_kr shared
  by the heads; the rope dims of q and k read as adjacent pairs
  (``view(..., dr/2, 2).transpose(-1, -2)``) and rotated by rotate-half
  with YaRN's frequencies; softmax((q_nope k_nope + q_pe k_pe) * scale,
  causal) v W_o, scale = (dn + dr)^-1/2 * mscale(s, mscale_all_dim)^2;
* the FFN: SiLU-gated (x W_gate) * (x W_up) W_down, dense in the first
  ``first_k_dense_replace`` layers; else the MoE: p = softmax(h W_r) over
  all ``router_experts``, the top ``num_experts_per_tok`` (greedy),
  gates = those p * ``routed_scaling_factor`` (renormalised only with
  ``norm_topk_prob``), y = sum over the token's top-k experts that are
  held of gate * expert(h), plus the ``n_shared_experts`` shared experts
  as one FFN of their summed width; the balance loss ``seq_aux``: f_e =
  count_e / (S K / E) over the sequence, aux = sum_e f_e mean_s p_se;
* pre-norm residuals (RMSNorm, eps ``rms_norm_eps``), a final norm, an
  untied head.

The loss of a batch of B sequences of S tokens: the mean token cross
entropy plus ``aux_loss_alpha`` times the layers' aux, each the mean over
the sequences. :func:`train_steps` takes global-norm clipping and AdamW
(decoupled decay) in float32.

Departures from the published code, none of them in the mathematics: the
weights are (in, out) and drawn here from a seed (:func:`weights`); the
causal softmax attention takes ``CHUNK`` query rows at a time, each
against the keys up to its last row (:func:`causal_attention`); the
backward recomputes each layer from its input (``torch.utils.checkpoint``);
neither changes a value; a held expert that no token picks gets a zero
gradient.
"""
from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


GROUP = 2  # sequences a forward and backward pass takes
CHUNK = 1024  # query rows an attention product takes


def _sub_seed(seed: int, name: str) -> int:
    digest = hashlib.blake2b(f"{name}:{int(seed)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


# --------------------------------------------------------------------------
# sizes and weights
# --------------------------------------------------------------------------


def sizes(hf: dict) -> dict:
    dep = hf.get("deployment", {})
    held = hf["n_routed_experts"]
    return {
        "D": hf["hidden_size"], "L": hf["num_hidden_layers"], "H": hf["num_attention_heads"],
        "r": hf["kv_lora_rank"], "dn": hf["qk_nope_head_dim"], "dr": hf["qk_rope_head_dim"],
        "dv": hf["v_head_dim"], "V": hf["vocab_size"], "F": hf["intermediate_size"],
        "Fe": hf["moe_intermediate_size"], "E": dep.get("router_experts", held),
        "e0": dep.get("experts_first", 0), "n": held, "K": hf["num_experts_per_tok"],
        "shared": hf["n_shared_experts"], "dense": hf["first_k_dense_replace"],
    }


def leaf_shapes(hf: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every weight: name -> (shape, init), init "dense" (normal over
    sqrt(fan-in), the first dim), "embed" (normal * 0.02) or "ones"."""
    s = sizes(hf)
    D, H, r, dn, dr, dv = s["D"], s["H"], s["r"], s["dn"], s["dr"], s["dv"]
    out = {"embed": ((s["V"], D), "embed")}
    for i in range(s["L"]):
        a = f"layers.{i}."
        out.update({
            a + "attn_norm": ((D,), "ones"),
            a + "q": ((D, H * (dn + dr)), "dense"),
            a + "dkv": ((D, r), "dense"),
            a + "kv_norm": ((r,), "ones"),
            a + "kr": ((D, dr), "dense"),
            a + "uk": ((r, H * dn), "dense"),
            a + "uv": ((r, H * dv), "dense"),
            a + "o": ((H * dv, D), "dense"),
            a + "ffn_norm": ((D,), "ones"),
        })
        if i < s["dense"]:
            out.update({a + "mlp.gate": ((D, s["F"]), "dense"),
                        a + "mlp.up": ((D, s["F"]), "dense"),
                        a + "mlp.down": ((s["F"], D), "dense")})
            continue
        out[a + "router"] = ((D, s["E"]), "dense")
        if s["shared"]:
            width = s["shared"] * s["Fe"]
            out.update({a + "shared.gate": ((D, width), "dense"),
                        a + "shared.up": ((D, width), "dense"),
                        a + "shared.down": ((width, D), "dense")})
        for e in range(s["e0"], s["e0"] + s["n"]):
            b = f"{a}experts.{e}."
            out.update({b + "gate": ((D, s["Fe"]), "dense"), b + "up": ((D, s["Fe"]), "dense"),
                        b + "down": ((s["Fe"], D), "dense")})
    out["final_norm"] = ((D,), "ones")
    out["lm_head"] = ((D, s["V"]), "dense")
    return out


def weight(seed: int, name: str, shape: tuple[int, ...], init: str,
           device: torch.device | str = "cpu") -> torch.Tensor:
    """The weight ``name`` of seed ``seed``: its own stream, so any subset
    is drawn in any order."""
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(_sub_seed(seed, name))
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(0.02) if init == "embed" else out.div_(math.sqrt(shape[0]))


def weights(hf: dict, seed: int, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    return {k: weight(seed, k, shape, init, device)
            for k, (shape, init) in leaf_shapes(hf).items()}


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_position_embeddings):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def inv_freq(hf: dict, device=None) -> torch.Tensor:
    """The rope dims' frequencies (dr/2,), YaRN's where ``rope_scaling``
    says "yarn", as the published ``DeepseekV2YarnRotaryEmbedding``."""
    dim, base = hf["qk_rope_head_dim"], hf["rope_theta"]
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** ar)
    y = hf.get("rope_scaling")
    if not y:
        return freq_extra
    assert y["type"] == "yarn", y
    freq_inter = 1.0 / (y["factor"] * base ** ar)
    low, high = yarn_find_correction_range(y["beta_fast"], y["beta_slow"], dim, base,
                                           y["original_max_position_embeddings"])
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(hf: dict) -> float:
    scale = (hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]) ** -0.5
    y = hf.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        m = yarn_get_mscale(y["factor"], y["mscale_all_dim"])
        scale = scale * m * m
    return scale


def cos_sin(hf: dict, S: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, dr) tables of the published code (the frequencies twice)."""
    y = hf.get("rope_scaling")
    factor = 1.0
    if y:
        factor = yarn_get_mscale(y["factor"], y["mscale"]) / yarn_get_mscale(
            y["factor"], y["mscale_all_dim"])
    freqs = torch.outer(torch.arange(S, dtype=torch.float32, device=device), inv_freq(hf, device))
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * factor, emb.sin() * factor


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, dr) in the published interleaved layout."""
    d = x.shape[-1]
    x = x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return x * cos + rotate_half(x) * sin


def causal_attention(q, k, v, scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v over (..., S, d), ``chunk`` query
    rows at a time, each against the keys up to its last row."""
    S = q.shape[-2]
    outs = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        scores = (q[..., c0:c1, :] @ k[..., :c1, :].transpose(-1, -2)) * scale
        seen = torch.arange(c1, device=q.device)[None, :] <= torch.arange(c0, c1,
                                                                         device=q.device)[:, None]
        scores = scores.masked_fill(~seen, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ v[..., :c1, :])
    return torch.cat(outs, dim=-2)


def attention(w: dict, a: str, h: torch.Tensor, hf: dict, rope) -> torch.Tensor:
    """h (G, S, D): G sequences, each attending within itself."""
    s = sizes(hf)
    G, S = h.shape[:2]
    H, dn, dr, dv = s["H"], s["dn"], s["dr"], s["dv"]
    q = (h @ w[a + "q"]).reshape(G, S, H, dn + dr).transpose(1, 2)  # (G, H, S, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    c = rms_norm(h @ w[a + "dkv"], w[a + "kv_norm"], hf["rms_norm_eps"])
    k_nope = (c @ w[a + "uk"]).reshape(G, S, H, dn).transpose(1, 2)
    v = (c @ w[a + "uv"]).reshape(G, S, H, dv).transpose(1, 2)
    k_pe = (h @ w[a + "kr"])[:, None]  # (G, 1, S, dr), one for every head
    cos, sin = rope
    q_pe, k_pe = apply_rotary(q_pe, cos, sin), apply_rotary(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(G, H, S, dr)], dim=-1)
    out = causal_attention(q, k, v, softmax_scale(hf))
    return out.transpose(1, 2).reshape(G, S, H * dv) @ w[a + "o"]


def ffn(w: dict, a: str, h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ w[a + "gate"]) * (h @ w[a + "up"])) @ w[a + "down"]


def route(w: dict, a: str, h: torch.Tensor, hf: dict):
    """h (G, S, D) -> (probs (G, S, E), gates (G, S, K), ids (G, S, K), the
    sequences' balance losses summed ())."""
    s = sizes(hf)
    assert hf.get("scoring_func", "softmax") == "softmax", hf.get("scoring_func")
    assert hf.get("topk_method", "greedy") == "greedy", hf.get("topk_method")
    E, K = s["E"], s["K"]
    probs = torch.softmax(h @ w[a + "router"], dim=-1)
    gates, ids = torch.topk(probs, k=K, dim=-1, sorted=False)
    if K > 1 and hf["norm_topk_prob"]:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        gates = gates * hf["routed_scaling_factor"]
    G, S = h.shape[:2]
    assert hf["seq_aux"], "the reference writes the sequence-wise balance loss only"
    f = torch.zeros((G, E), dtype=torch.float32, device=h.device)
    f = f.scatter_add(1, ids.reshape(G, S * K), torch.ones((G, S * K), device=h.device))
    f = f / (S * K / E)
    return probs, gates, ids, torch.sum(f * probs.mean(1))


def routed(w: dict, a: str, h: torch.Tensor, gates, ids, hf: dict) -> torch.Tensor:
    """The held experts' part of the layer, h (T, D): sum of gate * expert(h)
    over the token's picks that this chip holds (the picks grouped by
    expert)."""
    s = sizes(hf)
    tok, slot = torch.nonzero((ids >= s["e0"]) & (ids < s["e0"] + s["n"]), as_tuple=True)
    e_of = ids[tok, slot] - s["e0"]
    order = torch.argsort(e_of, stable=True)
    tok, slot = tok[order], slot[order]
    counts = torch.bincount(e_of, minlength=s["n"]).tolist()
    y = torch.zeros_like(h)
    for e, (t, k) in enumerate(zip(tok.split(counts), slot.split(counts), strict=True)):
        if t.numel():
            y = y.index_add(0, t, gates[t, k, None] * ffn(w, f"{a}experts.{s['e0'] + e}.", h[t]))
    return y


def moe(w: dict, a: str, h: torch.Tensor, hf: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """h (G, S, D) -> (the layer's output, the sequences' balance losses summed)."""
    _, gates, ids, aux = route(w, a, h, hf)
    D, K = h.shape[-1], ids.shape[-1]
    y = routed(w, a, h.reshape(-1, D), gates.reshape(-1, K), ids.reshape(-1, K), hf)
    y = y.reshape(h.shape)
    if sizes(hf)["shared"]:
        y = y + ffn(w, a + "shared.", h)
    return y, aux


def layer(w: dict, i: int, x: torch.Tensor, hf: dict, rope) -> tuple[torch.Tensor, torch.Tensor]:
    """x (G, S, D) -> (x out, the layer's balance losses summed over the
    sequences: 0 in a dense layer)."""
    a, eps = f"layers.{i}.", hf["rms_norm_eps"]
    x = x + attention(w, a, rms_norm(x, w[a + "attn_norm"], eps), hf, rope)
    h = rms_norm(x, w[a + "ffn_norm"], eps)
    if i < sizes(hf)["dense"]:
        return x + ffn(w, a + "mlp.", h), torch.zeros((), device=x.device)
    y, aux = moe(w, a, h, hf)
    return x + y, aux


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------


def forward(w: dict, tokens: torch.Tensor, hf: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequences (G, S) -> (logits (G, S, V), the layers' balance losses
    summed over the layers and the sequences)."""
    rope = cos_sin(hf, tokens.shape[-1], tokens.device)
    x, aux = w["embed"][tokens], torch.zeros((), device=tokens.device)
    for i in range(sizes(hf)["L"]):
        x, a = layer(w, i, x, hf, rope)
        aux = aux + a
    return rms_norm(x, w["final_norm"], hf["rms_norm_eps"]) @ w["lm_head"], aux


def loss(w: dict, tokens: torch.Tensor, targets: torch.Tensor, hf: dict) -> torch.Tensor:
    """A batch (B, S): the mean token cross entropy plus alpha times the
    layers' balance losses, each the mean over the sequences."""
    logits, aux = forward(w, tokens, hf)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    return ce + hf["aux_loss_alpha"] * aux / tokens.shape[0]


def grads(w: dict, tokens: torch.Tensor, targets: torch.Tensor, hf: dict
          ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(:func:`loss`, its gradient by weight), ``GROUP`` sequences at a time
    (the gradients summed over the groups), each layer recomputed from its
    input in the backward (the activations of one layer of one group live
    at a time)."""
    B, S = tokens.shape
    L, eps = sizes(hf)["L"], hf["rms_norm_eps"]
    ce_w, aux_w = 1.0 / (B * S), hf["aux_loss_alpha"] / B
    live = {k: v.detach().requires_grad_() for k, v in w.items()}
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    rope = cos_sin(hf, S, tokens.device)
    for b0 in range(0, B, GROUP):
        toks, tgts = tokens[b0:b0 + GROUP], targets[b0:b0 + GROUP]
        with torch.enable_grad():
            x, aux = live["embed"][toks], torch.zeros((), device=tokens.device)
            for i in range(L):
                x, a = checkpoint(layer, live, i, x, hf, rope, use_reentrant=False)
                aux = aux + a
            logits = rms_norm(x, live["final_norm"], eps) @ live["lm_head"]
            lb = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgts.reshape(-1),
                                 reduction="sum") * ce_w + aux_w * aux
            lb.backward()  # summed into each weight's .grad
        del x, logits
        total += lb.detach().double()
    return total.float(), {k: v.grad if v.grad is not None else torch.zeros_like(v)
                           for k, v in live.items()}


def train_steps(w: dict, batches, hf: dict, opt: dict, on_grad=None) -> list[float]:
    """AdamW steps over ``batches`` [(tokens (B, S), targets (B, S)), ...],
    ``w`` updated in place; each step's loss. ``opt``: lr, b1, b2, eps,
    weight_decay, clip. ``on_grad(step, grads)`` sees each step's clipped
    gradient."""
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses = []
    for t, (tokens, targets) in enumerate(batches, start=1):
        value, g = grads(w, tokens, targets, hf)
        losses.append(float(value))
        norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
        scale = torch.clamp(opt["clip"] / (norm + 1e-12), max=1.0)
        for v in g.values():
            v.mul_(scale)
        if on_grad is not None:
            on_grad(t, g)
        b1, b2 = opt["b1"], opt["b2"]
        for k, p in w.items():
            mu[k].mul_(b1).add_((1 - b1) * g[k])
            nu[k].mul_(b2).add_((1 - b2) * g[k] * g[k])
            step = (mu[k] / (1 - b1**t)) / (torch.sqrt(nu[k] / (1 - b2**t)) + opt["eps"])
            p.sub_(opt["lr"] * (step + opt["weight_decay"] * p))
        del g
    return losses
