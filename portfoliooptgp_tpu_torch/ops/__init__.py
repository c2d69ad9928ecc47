"""Linear algebra and the wrappers of the CUDA kernels (the NLL tiers and
the SVGP gram phase)."""
