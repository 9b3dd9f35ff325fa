"""Train an LM-substrate architecture end to end on the PyTorch port.

The twin of ``examples/lm_train.py``: a subprocess shim over ``python -m
repro_torch.launch.train`` at lr 1e-3, logging every 20 steps; smoke-sized
unless ``--full`` (qwen3-0.6b at full width fits one 80 GB GPU).

  PYTHONPATH=src python examples/lm_train_torch.py --arch qwen3-0.6b --steps 200 [--device cpu]
"""
import argparse
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="full config (needs a GPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda when absent (raises on a machine without a GPU)")
    args = ap.parse_args()
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch,
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--seq", str(args.seq), "--lr", "1e-3", "--log-every", "20",
    ]
    if not args.full:
        cmd.append("--smoke")
    if args.device:
        cmd += ["--device", args.device]
    sys.exit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
