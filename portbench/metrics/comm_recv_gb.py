"""comm_recv_gb: the bytes the program's collectives received on rank 0 in
a traced epoch (train step and evaluation), by the mesh's `ByteCounter`
(`parallel/collectives.py`: ring-model receive bytes of each all_gather,
reduce_scatter and all_reduce), in GB (1e9 bytes) a traced epoch. None on
one card. Layer: collectives (`parallel/collectives.py`, the sharded
branches of `ops/spgemm.py`, `parallel/train.py`)."""


def read(record):
    per_epoch = record.get("comm_recv_bytes")
    if not per_epoch:
        return None
    return sum(per_epoch) / len(per_epoch) / 1e9
