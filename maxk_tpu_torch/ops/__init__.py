"""Aggregation ops, the MaxK mask and the CUDA kernel wrappers."""
