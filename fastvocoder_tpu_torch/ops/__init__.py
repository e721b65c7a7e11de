"""Convolution primitives and the port's CUDA kernels with their plain
PyTorch versions."""
