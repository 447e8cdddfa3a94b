"""Patch data: the npz dataset and the synthetic generator."""
