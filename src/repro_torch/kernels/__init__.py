"""The port's kernels: hand-written CUDA C++ (``csrc/``), built at first use
by ``build.py``, wrapped in ``predict.py``, ``svgp_proj.py`` and ``rbf.py``,
dispatched by ``ops.py``, each beside its plain PyTorch version in
``ref.py``."""
