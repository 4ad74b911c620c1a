"""The benchmark of the PyTorch port (``vanishing_points_2017_tpu_torch``).

``python3 -m vpbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on a CUDA card.
"""
