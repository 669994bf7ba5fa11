"""Benchmark entry points: `python -m maxk_tpu_torch.bench` (the `bench.py`
record), `.kernel_bench`, `.micro`, `.probe_topk` and `.probe_bricks`."""
