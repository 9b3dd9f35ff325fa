"""PyTorch + CUDA port of the PSVGP (the paper's partitioned sparse GP).

The JAX package ``repro`` is the reference; this package mirrors its
module paths and names and imports neither ``jax`` nor anything of
``repro`` (numpy-only modules are copied, not imported), so it runs on a
GPU machine that has no JAX. Entry points run on ``"cuda"`` unless the
caller asks for ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).

The port trains (``api.fit`` / ``refit``, each SGD step's ELBO
projection in a hand-written CUDA kernel), saves and loads artifacts and
train states in the JAX package's formats (``checkpoint``), serves them
(``api.Server``: ``submit`` / ``submit_many`` / ``stream``, the cached
posterior evaluated by the CUDA kernels of ``repro_torch.kernels``), goes
live with a refit model under traffic (``Server.swap``), and answers many
small clients in process (``api.FrontDoor``) or over HTTP
(``repro_torch.net``). ``gp.exact_gp_logml`` / ``exact_gp_predict`` are
the SVGP's exact oracle.
"""
