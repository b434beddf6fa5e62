"""The benchmark of ``fedml_tpu_torch``: FedAvg rounds through
``FedAvgSimulation.run_round`` on one NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration (``configs/``), traffic mix (``traffic/``), per-layer metric
(``metrics/``) and cell's correctness limits (``limits/``) is a file of its
own, found by the name ``BENCHMARK.json`` gives it.  ``reference/`` is the
plain float32 PyTorch that decides ``correct``; it imports nothing of the
program.
"""
