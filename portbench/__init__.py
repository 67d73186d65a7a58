"""The benchmark of `neptune_tpu_torch` on one NVIDIA H100: `run.py` runs one
cell of `BENCHMARK.json` once. Nothing here imports JAX or `neptune_tpu`."""
