"""Tensor operations; ``nms_cuda`` and ``cgm_cuda`` wrap the CUDA kernels."""
