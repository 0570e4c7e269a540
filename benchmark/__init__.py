"""The benchmark of the PyTorch port (`fbanet_tpu_torch`) on the H100:
`python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1`.
`BENCHMARK.json` at the repository root names its cells, configurations,
mixes and metrics; `benchmark/manifest.py` finds their files by name."""
