"""Evaluation: the metrics, the harness and its baselines, and full-scene
tiled inference."""
