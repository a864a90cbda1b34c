"""The benchmark of the PyTorch/CUDA port (``ape_x_dqn_tpu_torch``): one
command runs one cell of ``BENCHMARK.json`` once (``python3 -m
benchmark.run``).  Configurations, traffic mixes and per-layer metrics are
files of their own under ``configs/``, ``traffic/`` and ``metrics/``,
found by the names ``BENCHMARK.json`` gives them."""
