"""Attention ops of the port: oracle, kernels' host functions, KV cache."""
