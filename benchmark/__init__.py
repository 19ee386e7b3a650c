"""The benchmark of mercury_tpu_torch: see README.md and BENCHMARK.json."""
