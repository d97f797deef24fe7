"""Parallel helpers of the port (only combine_partials so far)."""
