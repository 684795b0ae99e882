"""The benchmark of the PyTorch/CUDA port's CG pipeline (``repro_torch``).

``run.py`` runs one cell once; ``harness/`` is the general machinery;
``configs/``, ``traffic/``, ``workloads/`` and ``metrics/`` hold one file
per configuration, traffic mix, cell and metric, found by the names in
``BENCHMARK.json``; ``reference/`` is the plain semantics that decides
``correct``.
"""
