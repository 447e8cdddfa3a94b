"""Patch data: the npz dataset, its loader, the synthetic generator and the
valid-mask z-score."""
