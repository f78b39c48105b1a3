"""The benchmark of vtd_tpu_torch on the card: see BENCHMARK.json and PERF.md."""
