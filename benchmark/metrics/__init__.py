"""One reader a metric, found by its name in BENCHMARK.json (see README.md)."""
