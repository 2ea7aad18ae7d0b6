"""Data of the port: datasets, transforms, collate and the host pipeline."""
