"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
serves one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Everything a cell, a configuration or a per-layer metric needs is
found by name: ``configs/<config>.json``, ``cells/<traffic>.json``,
``metrics/<metric>.py`` and ``reference/<family>.py``.
"""
