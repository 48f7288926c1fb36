"""The benchmark of the PyTorch and CUDA port (``weclip_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on a CUDA card; ``BENCHMARK.json`` at
the root names the cells and metrics, and ``spec.py`` says where each one's
files are."""
