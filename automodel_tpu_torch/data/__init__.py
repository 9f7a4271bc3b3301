"""Datasets, collators and the data loader (torch port; numpy level)."""
