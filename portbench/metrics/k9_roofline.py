"""k9_roofline: K9's (`spmm_csr`, y = A @ x) read-once bound over its device
time in the trace, in %. The bound is the CSR (row pointers, live columns
and weights), x and y once each over the card's memory rate, summed over
K9's launches; the time is its kernel and its partial-sum pass
(`combine_kernel`, which only K9 launches where K10 and K11 do not run).
Layer: kernels (`csrc/spmm_csr.cu`)."""

from portbench.roofline import bound_seconds, k9_bytes

OTHERS = ("spgemm_cbsr_kernel", "sspmm_cbsr_kernel")


def read(record):
    ops = record["trace"]["ops"]
    k9 = [v for n, v in ops.items() if n.startswith("spmm_csr_kernel")]
    if not k9:
        return None
    launches = sum(v["count"] for v in k9)
    seconds = sum(v["seconds"] for v in k9)
    if not any(n.startswith(OTHERS) for n in ops):
        seconds += sum(v["seconds"] for n, v in ops.items() if n.startswith("combine_kernel"))
    itemsize = 2 if record["traffic"].get("compute_dtype") == "bfloat16" else 4
    nbytes = k9_bytes(record["num_nodes"], record["live_edges"], record["config"]["hidden_dim"],
                      itemsize)
    return 100.0 * launches * bound_seconds(nbytes) / seconds
