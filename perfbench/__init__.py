"""The benchmark of the PyTorch/CUDA port (`modegpt_tpu_torch`) on one NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json` once. Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own
(`configs/`, `traffic/`, `metrics/`), found by the name `BENCHMARK.json`
gives it; `drivers/` holds one file per kind of traffic.
"""
