"""A benchmark of the H100 port, guard_tpu_torch: see BENCHMARK.json and PERF.md."""
