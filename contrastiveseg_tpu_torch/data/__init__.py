"""Data of the port: datasets (with SegFix's offset targets and the
multi-dataset sampler), transforms, collate and the host pipeline."""
