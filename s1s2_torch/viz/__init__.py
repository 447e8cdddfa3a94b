"""PNG previews."""
