"""The benchmark of maxk_tpu_torch: full-graph GNN training epochs on one card.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell; `README.md` says what each file holds.
"""
