"""Diffusion math core: schedules and the forward-process algebra."""
