"""spmm_ms_per_epoch: device time of the aggregation's kernels per traced
epoch, in ms: K9 and its partial-sum pass, K10 with its selector merge, K11,
and the CBSR densify and sample (K2, K3) where a mode routes there. Layer:
aggregation (`ops/spgemm.py`, `ops/spmm_csr.py`, `ops/dispatch.py`)."""

KERNELS = ("spmm_csr_kernel", "combine_kernel", "spgemm_cbsr_kernel", "cbsr_merge_kernel",
           "sspmm_cbsr_kernel", "densify_kernel", "sample_kernel")


def read(record):
    ops = record["trace"]["ops"]
    seconds = [v["seconds"] for n, v in ops.items() if n.startswith(KERNELS)]
    if not seconds or not record["stamps"]:
        return None
    return 1e3 * sum(seconds) / len(record["stamps"])
