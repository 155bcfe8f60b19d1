"""Benchmark of eventql_tpu_torch: see BENCHMARK.json at the repository root."""
