"""CSR and CBSR containers and the per-graph operator bundle."""
