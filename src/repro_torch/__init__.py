"""PyTorch + CUDA port of the PSVGP serving path.

The JAX package ``repro`` is the reference; this package mirrors its
module paths and names and imports neither ``jax`` nor anything of
``repro`` (numpy-only modules are copied, not imported), so it runs on a
GPU machine that has no JAX. Entry points run on ``"cuda"`` unless the
caller asks for ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).

Slice 1 serves a saved artifact: ``api.FittedPSVGP.load`` ->
``api.Server(fitted, ServeConfig(mode="sharded"))`` -> ``submit`` /
``submit_many`` / ``stream``, with the cached-posterior evaluation in the
hand-written CUDA kernels of ``repro_torch.kernels``.
"""
