"""Utilities of the port: device timing."""
