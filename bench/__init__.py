"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything that belongs to one
configuration, traffic mix, entry or metric sits in a file of its own,
found by its name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``entries/<entry>.py`` (named by the mix), ``metrics/<metric>.py`` and
``limits/<cell>.json``. The yardstick (the field's generator, the counts
of operations and bytes, the reduction of a profiler trace, the plain
reference and the comparison that decides ``correct``) lives here too, and
imports nothing of the JAX package.
"""
