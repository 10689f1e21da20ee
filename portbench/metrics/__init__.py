"""Per-layer metric readers, one file per metric of BENCHMARK.json's
`per_layer`: read(run) -> number or None, over the traced window (run.trace)
and what the run counted. A reader that finds nothing to read returns None,
and the metric is left out of the line."""
