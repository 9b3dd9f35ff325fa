"""Serving entry point of the port: batched prefill + autoregressive decode of an
LM, and the GP serving mode for the stitched PSVGP surface (port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 4 --prompt-len 128 --gen 32 [--smoke] [--device cpu]

LM mode: random parameters from ``--seed`` on the device, seeded prompts,
one prefill step, then ``--gen - 1`` decode steps against the KV cache
(``runtime.steps``); greedy at ``--temperature 0``, else sampled from a
``torch.Generator`` seeded from ``--seed`` (the draws are not JAX's).

GP mode (``--gp``): fit the partitioned surface on the synthetic E3SM-like field (or load a
saved artifact, either package's) and answer a stream of query batches
with a latency/throughput report. A thin shim over ``repro_torch.api``:
the flags parse into a ``FitConfig``/``ServeConfig`` and ``api.Server``
serves.

  PYTHONPATH=src python -m repro_torch.launch.serve --gp --gp-grid 8 --gp-m 10

``--sharded`` serves the halo program (``repro_torch.launch.serve_sharded``:
the one-process program, or the mesh lane under ``torchrun``); ``--http``
serves over HTTP (``repro_torch.net.server``). Runs on ``--device``,
``cuda`` when absent.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_gp(args) -> None:
    """Batched query loop over the blended PSVGP surface: fit (or load) the
    artifact, then serve the request stream through a replicated
    ``api.Server``."""
    from repro_torch import api
    from repro_torch.launch.serve_sharded import load_or_train, query_batches, session_configs

    fit_cfg, serve_cfg, _ = session_configs(args, expect_mode="replicated")
    ds, fitted = load_or_train(args, fit_cfg=fit_cfg)

    t0 = time.perf_counter()
    if serve_cfg is None:
        serve_cfg = api.ServeConfig(mode="replicated")
    server = api.Server(fitted, serve_cfg)
    if ds is not None:
        print(f"posterior cache built in {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"on {server.device} (one O(P m^3) factorization, reused by every request)")
    else:
        print(f"posterior cache restored from the artifact on {server.device} "
              "(no factorization at serve time)")

    batches = query_batches(
        fitted.grid, ds, batch=args.gp_batch, requests=args.gp_requests,
        seed=args.seed, skew=args.gp_skew,
    )
    report = server.stream(batches)
    pct, qps = report["latency_ms"], report["points_per_s"]
    print(f"served {args.gp_requests} requests x {args.gp_batch} points")
    print(f"latency/request ms: p50={pct['p50_ms']:.2f} "
          f"p95={pct['p95_ms']:.2f} p99={pct['p99_ms']:.2f}")
    print(f"throughput: {qps:,.0f} points/s")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def lm_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The JAX CLI's prompts: (batch, prompt_len) int32 from
    ``default_rng(seed)``."""
    return lm_request(cfg, batch, prompt_len, seed)[0]


def lm_request(cfg, batch: int, prompt_len: int, seed: int):
    """The JAX CLI's inputs from one ``default_rng(seed)``: the prompts,
    then, for an encoder-decoder, the stub frame embeddings (batch,
    num_frames, frontend_dim), then, for a VLM, the stub patch embeddings
    (batch, num_patches, vit_dim), both float32 (None where the config has
    no such stub). Returns (prompts, frames, patches)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    frames = patches = None
    if cfg.encoder is not None:
        e = cfg.encoder
        frames = rng.normal(size=(batch, e.num_frames, e.frontend_dim)).astype(np.float32)
    if cfg.vision is not None:
        v = cfg.vision
        patches = rng.normal(size=(batch, v.num_patches, v.vit_dim)).astype(np.float32)
    return prompts, frames, patches


def generate(params, cfg, prompts, gen: int, *, temperature: float = 0.0,
             generator=None, frames=None, patches=None) -> dict:
    """Prefill ``prompts`` (B, S) on their device (an encoder-decoder's
    ``frames`` through the encoder; a VLM's ``patches`` prepended: the
    cache and the decode positions count them), then ``gen - 1`` decode
    steps without frames or patches: the first token greedy, as the JAX
    CLI's, the rest greedy at ``temperature`` 0, else sampled with
    ``generator``. Returns the (B, gen) tokens, the last step's logits and
    both phases' seconds, each timed to a synchronize."""
    import torch

    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    B, S = prompts.shape
    dev = prompts.device
    P = patches.shape[1] if patches is not None else 0
    prefill = make_prefill_step(cfg, cache_len=S + gen + P)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, frames=frames, patches=patches)
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, cache, P + S + i, tok)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits, dim=-1)[:, None]
        generated.append(tok)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": t_dec}


def serve_lm(args) -> None:
    """The LM serving loop of ``--arch``, at full width unless ``--smoke``."""
    import torch

    from repro_torch.configs import get, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_model_params

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model_params(gen, cfg)
    B, S = args.batch, args.prompt_len
    prompts, frames, patches = lm_request(cfg, B, S, args.seed)
    prompts = torch.from_numpy(prompts).to(dev)
    if frames is not None:
        frames = torch.from_numpy(frames).to(dev)
    if patches is not None:
        patches = torch.from_numpy(patches).to(dev)
    out = generate(params, cfg, prompts, args.gen, temperature=args.temperature, generator=gen,
                   frames=frames, patches=patches)
    t_prefill, t_dec = out["prefill_s"], out["decode_s"]
    print(f"arch={cfg.name} device={dev} dtype={cfg.dtype}")
    if frames is not None:
        print(f"frames: {B}x{frames.shape[1]} x {frames.shape[2]} through the encoder")
    if patches is not None:
        print(f"patches: {B}x{patches.shape[1]} x {patches.shape[2]} prepended")
    print(f"prefill: {B}x{S} tokens in {t_prefill * 1e3:.1f} ms "
          f"({B * S / t_prefill:,.0f} tok/s)")
    print(f"decode: {args.gen} steps x {B} seqs in {t_dec * 1e3:.1f} ms "
          f"({B * (args.gen - 1) / max(t_dec, 1e-9):,.0f} tok/s)")
    print("sample row 0:", out["tokens"][0].cpu().numpy()[:16], "...")


def main() -> None:
    from repro_torch.launch.serve_sharded import add_gp_args

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="LM serving: the architecture id (e.g. qwen3-0.6b)")
    ap.add_argument("--smoke", action="store_true", help="LM: the reduced config")
    ap.add_argument("--batch", type=int, default=4, help="LM: sequences")
    ap.add_argument("--prompt-len", type=int, default=64, help="LM: prompt tokens")
    ap.add_argument("--gen", type=int, default=32, help="LM: generated tokens")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="LM: sampling temperature (0 = greedy)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gp", action="store_true", help="serve the stitched PSVGP surface")
    ap.add_argument("--sharded", action="store_true",
                    help="GP mode: serve the halo program "
                         "(repro_torch.launch.serve_sharded) instead of the "
                         "replicated cache")
    add_gp_args(ap)
    args = ap.parse_args()

    if args.sharded and not args.gp:
        ap.error("--sharded only applies to the GP serving mode (add --gp)")
    if args.http and not args.gp:
        ap.error("--http only applies to the GP serving mode (add --gp)")
    if not args.gp:
        if not args.arch:
            ap.error("--arch required (or --gp for the PSVGP surface)")
        if min(args.batch, args.prompt_len, args.gen) < 1:
            ap.error("--batch, --prompt-len and --gen must be >= 1")
        serve_lm(args)
        return
    if args.gp_requests < 1 or args.gp_batch < 1:
        ap.error("--gp-requests and --gp-batch must be >= 1")
    if args.http:
        from repro_torch.launch.serve_sharded import HTTP_UNDER_TORCHRUN, launched_as_rank
        from repro_torch.net.server import serve_http

        if launched_as_rank():
            ap.error(HTTP_UNDER_TORCHRUN)

        serve_http(args, expect_mode="sharded" if args.sharded else "replicated")
        return
    if args.sharded:
        from repro_torch.launch.serve_sharded import serve_sharded

        serve_sharded(args)
    else:
        serve_gp(args)


if __name__ == "__main__":
    main()
