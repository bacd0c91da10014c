"""cardbench: the benchmark of ``avenir_tpu_torch`` on NVIDIA cards.

``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  See README.md.
"""
