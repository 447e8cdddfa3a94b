"""UNetSmall and its int8 inference path."""
