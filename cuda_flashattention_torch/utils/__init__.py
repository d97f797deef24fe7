"""Utilities of the port: device timing and peaks, profiling, logging,
checkpoints, the card monitor and the tuner."""
