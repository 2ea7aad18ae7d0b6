"""Tensor ops of the port: resizes, anchor sampling, InfoNCE, memory bank,
the small-channel 3x3 conv, the fused eval BasicBlock, the confusion
matrix, and the CUDA kernels' build helper."""
