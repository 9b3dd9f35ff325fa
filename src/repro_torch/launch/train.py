"""Training entry point for the LM substrate (port of ``repro.launch.train``).

Runs real steps on one device (``--device``, ``cuda`` when absent; raises
without a GPU unless given ``--device cpu``): random parameters from
``--seed``, the synthetic token pipeline, AdamW with global-norm clipping
(``runtime.steps.make_train_step``), checkpoints in the JAX package's
format. The loss is read back to the host only every ``--log-every``
steps.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 --batch 8 --seq 128 [--smoke] [--device cpu]

An encoder-decoder's batches carry stub ``"frames"`` and a VLM's stub
``"patches"``, drawn as JAX's CLI draws them. The port-only architectures
(``configs.PORT_ARCH_IDS``, e.g. ``--arch deepseek-v2-lite-ep8``) clip and
update in place (``make_train_step(in_place=True)``). ``--ckpt-dir`` resumes from
the latest checkpoint there (either package's) and continues the token
and stub streams and the step count where the saved state stopped; JAX's
CLI restarts them at 0. The mesh is JAX's CLI's: ``make_host_mesh()``
(the devices this program drives, (1, 1) for one process) and the state's
``state_pspecs`` on it, printed as ``mesh=`` and the count of leaves the
rules shard; on one device every leaf is whole there, so the step runs
as it is.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def device_batch(tokens: np.ndarray, targets: np.ndarray, device, *,
                 frames: np.ndarray | None = None, patches: np.ndarray | None = None) -> dict:
    """One (tokens, targets) pair of ``synthetic_token_batches`` on
    ``device``, with an encoder-decoder's stub ``frames`` and a VLM's stub
    ``patches`` when given."""
    import torch

    batch = {"tokens": tokens, "targets": targets, "frames": frames, "patches": patches}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items() if v is not None}


def stub_stream(cfg, batch: int, seed: int, skip: int = 0):
    """(frames, patches) for each step, as JAX's CLI draws them from one
    ``default_rng(seed)``: an encoder-decoder's (batch, num_frames,
    frontend_dim), then a VLM's (batch, num_patches, vit_dim), float32,
    None where the config has no such stub; the first ``skip`` steps'
    draws discarded (a resumed run continues the stream)."""
    rng = np.random.default_rng(seed)
    e, v = cfg.encoder, cfg.vision
    shapes = ((batch, e.num_frames, e.frontend_dim) if e is not None else None,
              (batch, v.num_patches, v.vit_dim) if v is not None else None)

    def draw():
        return tuple(None if sh is None else rng.normal(size=sh).astype(np.float32)
                     for sh in shapes)

    for _ in range(skip if any(shapes) else 0):
        draw()
    while True:
        yield draw()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda when absent (raises on a machine without a GPU)")
    args = ap.parse_args()
    if min(args.steps, args.batch, args.seq, args.log_every) < 1 or args.ckpt_every < 0:
        ap.error("--steps, --batch, --seq and --log-every must be >= 1, --ckpt-every >= 0")

    import torch

    from repro_torch.checkpoint import load_train_state, save_train_state
    from repro_torch.configs import PORT_ARCH_IDS, canon, get, get_smoke
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import state_pspecs
    from repro_torch.sharding.rules import leaf_specs

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    mesh = make_host_mesh()
    print(f"arch={cfg.name} device={dev} mesh={mesh.shape}")
    state = init_train_state(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    if args.ckpt_dir:
        restored = load_train_state(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"restored checkpoint at step {int(state.step)}")
    n_params = sum(leaf.numel() for leaf in tree_leaves(state.params))
    print(f"parameters: {n_params / 1e6:.2f}M")
    specs = leaf_specs(state_pspecs(state, mesh).params)
    print(f"sharding: {sum(any(e is not None for e in s) for s in specs)} of {len(specs)} "
          f"parameter leaves sharded on mesh {mesh.label()}")

    # the port-only configs are sized to the card: the step updates in place
    step_fn = make_train_step(cfg, learning_rate=args.lr,
                              in_place=canon(args.arch) in PORT_ARCH_IDS)
    start = int(state.step)
    data = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                                   num_batches=args.steps, start_row=start)
    stubs = stub_stream(cfg, args.batch, args.seed, skip=start)
    t0 = time.perf_counter()
    for i, ((toks, targets), (fr, pt)) in enumerate(zip(data, stubs), start=start + 1):
        state, metrics = step_fn(state, device_batch(toks, targets, dev, frames=fr, patches=pt))
        if (i - start) % args.log_every == 0:
            loss, ce = float(metrics["loss"]), float(metrics["ce"])  # the one host read
            dt = time.perf_counter() - t0
            tok_s = args.batch * args.seq * args.log_every / dt
            print(f"step {i:5d}  loss {loss:.4f}  ce {ce:.4f}  {tok_s:,.0f} tok/s")
            t0 = time.perf_counter()
        if args.ckpt_dir and args.ckpt_every and i % args.ckpt_every == 0:
            print(f"checkpoint -> {save_train_state(args.ckpt_dir, i, state)}")
    print("done.")


if __name__ == "__main__":
    main()
