"""build_graph_s: the host clock around `build_graph` in set-up (the norm
folded in, Aᵀ built and the symmetry check on the host, both CSRs moved and
their segment tables built on the card), in s. Layer: graph build
(`sparse/graph.py`, `sparse/csr.py`)."""


def read(record):
    return record.get("build_graph_s")
