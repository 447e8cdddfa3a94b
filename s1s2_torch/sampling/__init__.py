"""Samplers and timestep grids."""
