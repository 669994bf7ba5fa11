"""cbsr_pair_roofline: the read-once bound of K10 (`spgemm_cbsr`, with its
merge pass) and K11 (`sspmm_cbsr`), summed over their launches in the trace,
over their device time, in %. K10's bytes: the CSR once, each node's merged
row (k values, k int16 selectors) and y (V × D) written; K11's: Aᵀ's CSR
once, g (V × D) and the int32 selectors read, dvals (V × k) written
(`roofline.k10_bytes`, `k11_bytes`). The time is K10's kernel, its merge
(`cbsr_merge_kernel`) and its partial-sum pass (`combine_kernel`, counted
only where K9, which launches it too, does not run), and K11's kernel. None
where neither runs. Layer: kernels (`csrc/spmm_csr.cu`)."""

from portbench.roofline import bound_seconds, k10_bytes, k11_bytes

K10 = ("spgemm_cbsr_kernel", "cbsr_merge_kernel")
K11 = ("sspmm_cbsr_kernel",)


def read(record):
    ops = record["trace"]["ops"]
    k10 = sum(v["count"] for n, v in ops.items() if n.startswith(K10[0]))
    k11 = sum(v["count"] for n, v in ops.items() if n.startswith(K11))
    if not k10 and not k11:
        return None
    seconds = sum(v["seconds"] for n, v in ops.items() if n.startswith(K10 + K11))
    if not any(n.startswith("spmm_csr_kernel") for n in ops):
        seconds += sum(v["seconds"] for n, v in ops.items() if n.startswith("combine_kernel"))
    itemsize = 2 if record["traffic"].get("compute_dtype") == "bfloat16" else 4
    v, e = record["num_nodes"], record["live_edges"]
    d, k = record["config"]["hidden_dim"], record["traffic"]["maxk"]
    bound = (k10 * bound_seconds(k10_bytes(v, e, d, k, itemsize))
             + k11 * bound_seconds(k11_bytes(v, e, d, k, itemsize)))
    return 100.0 * bound / seconds
