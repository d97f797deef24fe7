"""Serving model of the port: transformer, parameter conversion, generate()."""
