"""Metrics of the port: the segmentation confusion-matrix accumulator."""
