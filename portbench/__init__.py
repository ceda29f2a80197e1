"""The benchmark of the PyTorch and CUDA port (``vk_merkle_roots_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on ``cuda:0``.
"""
