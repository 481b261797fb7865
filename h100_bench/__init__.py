"""Benchmark of mmdti_tpu_torch on one NVIDIA H100.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json once and prints one JSON
line.  Cells, model configurations (``configs/``), traffic mixes
(``mixes/``), per-layer metric readers (``metrics/``) and the drivers that
run a mix (``drivers/``) are found by name; ``reference/`` is the plain
PyTorch model that decides ``correct``.
"""
