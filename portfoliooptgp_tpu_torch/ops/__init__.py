"""Linear algebra and the wrappers of the CUDA NLL kernels."""
