"""Quickstart of the PyTorch port: fit a PSVGP to a synthetic global
temperature field on the GPU.

The twin of ``examples/quickstart.py``: data -> partitioning -> PSVGP
training (delta-weighted neighbor sampling) -> stitched prediction -> the
paper's two metrics, through ``repro_torch``. On CUDA every training step
runs the ELBO's projection in the port's CUDA kernel.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import psvgp, svgp
from repro_torch.core.metrics import boundary_rmsd, per_partition_rmspe, rmspe
from repro_torch.core.neighbors import boundary_probes
from repro_torch.core.partition import make_grid, partition_data
from repro_torch.data.spatial import e3sm_like_field
from repro_torch.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=12_000, help="observations")
    ap.add_argument("--grid", type=int, default=10, help="partition grid side")
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda when absent (raises on a machine without a GPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # 1. an E3SM-like field: ~12k observations, pole-sparse like the paper's
    ds = e3sm_like_field(n=args.n, seed=0)

    # 2. a 10x10 grid of spatially contiguous partitions (the in-situ layout:
    #    each partition would live on its own rank in production)
    grid = make_grid(ds.x, gx=args.grid, gy=args.grid)
    data = partition_data(ds.x, ds.y, grid, device=dev)
    print(f"partitions: {data.num_partitions}, padded size: {data.n_max}, "
          f"counts: min={int(data.counts.min())} max={int(data.counts.max())}, on {dev}")

    # 3. PSVGP: m=5 inducing points per partition, delta=0.125 neighbor
    #    sampling (the paper's sweet spot)
    cfg = psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(num_inducing=5, input_dim=2, use_pallas=dev.type == "cuda"),
        delta=0.125,
        batch_size=32,
        learning_rate=0.02,
        comm="gather",  # paper-faithful mode; "ppermute" = the direction-permutation mode
    )
    static = psvgp.build(cfg, data)
    state = psvgp.init(0, cfg, data)

    print(f"training {args.iters} iterations (all {data.num_partitions} partitions in parallel)...")
    state = psvgp.fit(static, state, data, args.iters, log_every=500)

    # 4. the paper's metrics
    probes = boundary_probes(grid, probes_per_edge=8)
    print(f"RMSPE           : {float(rmspe(static, state, data)):.4f}")
    print(f"boundary RMSD   : {float(boundary_rmsd(static, state, probes)):.4f}")
    pp = per_partition_rmspe(static, state, data)
    print(f"worst partition : {float(pp.max()):.4f} (pole partitions are hardest)")


if __name__ == "__main__":
    main()
