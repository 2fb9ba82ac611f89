"""The H100 benchmark of the PyTorch and CUDA port (``closerlook3d_tpu_torch``).

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Configurations,
traffic mixes, per-layer metric readers, layer op lists and limits are
files found by name under this folder.
"""
