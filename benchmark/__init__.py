"""The benchmark of the PyTorch and CUDA port (``tpuseg_torch``): one cell
of ``BENCHMARK.json`` per run, ``python3 -m benchmark.run --workload NAME
--seed N --seconds S --trace 0|1``."""
