"""The benchmark of lsm_tpu_torch (BENCHMARK.json at the repository root)."""
