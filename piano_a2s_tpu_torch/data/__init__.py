"""Datasets, the data preparation and their metadata (the time-signature
table, the split lists)."""
