"""The port's kernels: hand-written CUDA C++ (``csrc/``), built at first use
by ``build.py``, wrapped in ``predict.py``, ``svgp_proj.py``, ``rbf.py``,
``draws.py`` and ``adam.py``, each counting its launches in ``launches.py``.
One rule, ``ops.on_cuda``, picks a kernel or its plain version: ``ops.py``
dispatches every entry to the kernel or its twin in ``ref.py``, and
``optim/adam.py`` asks it for the Adam update."""
