"""The port's tools: the kernel-vs-oracle differential fuzzer
(`kernel_fuzz`), the coverage-guided parser fuzzer (`fuzz`), the
metrics snapshot checker (`check_metrics_schema`), the run ledger's
backfill command (`perf_ledger`) and the npm package's build
(`ts_build`). Each runs as `python -m guard_tpu_torch.tools.<name>`."""
