"""The port's kernels: hand-written CUDA C++ (``csrc/``), built at first use
by ``build.py``, wrapped in ``predict.py``, ``svgp_proj.py`` and ``rbf.py``,
dispatched by ``ops.py``, each beside its plain PyTorch version in
``ref.py``; the Adam update (``adam.py``), dispatched by
``optim/adam.py`` beside its plain formula; and the training step's draws
(``draws.py``), called by ``core/psvgp.py``'s gather step on CUDA."""
