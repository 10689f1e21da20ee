"""End-to-end metric readers, one file per metric of BENCHMARK.json's
`end_to_end`: read(run) -> number, over the untraced window."""
