"""Per-layer metric readers: `<metric>.py` holds `read(record)`, which returns
the metric's value from a traced run's record, or None where the record
holds nothing to read (the harness then leaves the metric out). The record
(`portbench.run.traced_record`) holds `stamps` (host perf_counter seconds
of each traced epoch: start, train step done, evaluation read, loss read),
`trace` (`portbench.trace.reduce`: `ops` by kernel name with count and
seconds, `busy_s`, `window_s`, `idle_gaps`), `config`, `traffic`,
`num_nodes`, `live_edges` and `build_graph_s`."""
