"""Metrics of the port: the segmentation confusion-matrix accumulator, the
official and per-dataset evaluators, SegFix's direction counters and the
instance-level AP."""
