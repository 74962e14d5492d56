"""The benchmark of ``flash_viterbi_tpu_torch`` on one NVIDIA GPU.

``python3 -m fvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Configurations, traffic mixes,
entries, cells and metrics are files of their own under this folder, found
by the names ``BENCHMARK.json`` gives (see ``run.py``).
"""
