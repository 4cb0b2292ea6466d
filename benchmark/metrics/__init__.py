"""One reader a metric, found by the metric's name in BENCHMARK.json
(benchmark/metrics/<name>.py). Each defines `read(run)` on a finished run
(benchmark.run.Run) and returns the metric's value, or None where the run
has nothing to read: the harness then leaves the metric out of the
result's line."""
