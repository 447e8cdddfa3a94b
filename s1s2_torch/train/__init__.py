"""Checkpoint loading (training itself is a later part of the port)."""
