"""Tracing, step timing and metrics logging."""
