"""Per-layer metric readers: `<metric>.py` holds `read(record)`, which returns
the metric's value from a traced run's record, or None where the record
holds nothing to read (the harness then leaves the metric out). The record
(`portbench.run.traced_record`) holds `stamps` (host perf_counter seconds
of each traced epoch: start, train step done, evaluation read, loss read),
`trace` (`portbench.trace.reduce`: `ops` by kernel name with count and
seconds, `intervals`, `busy_s`, `window_s`, `idle_gaps`), `config`,
`traffic`, `num_nodes`, `live_edges` (the whole graph's), `build_graph_s`,
`chips` (the cards the run uses) and, on several cards,
`comm_recv_bytes` (the program's `ByteCounter` receive bytes of each traced
epoch). On several cards the record is rank 0's."""
