"""Process-level utilities of the port: ``multihost`` (process groups
across hosts and ranks)."""
