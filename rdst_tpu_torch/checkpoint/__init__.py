"""Checkpoint reading for the port: flax msgpack snapshots without flax."""
