"""Standalone command-line tools of the port (no user code required)."""
