"""Command-line tools of the port (the multi-process launcher)."""
