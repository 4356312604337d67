"""Runners of the port (the trainer)."""
