"""PyTorch/CUDA port of `portfoliooptgp_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: module paths and public
names mirror it (`kernels/stationary.py`, `models/gpr.py`,
`pipelines/walk_forward.py`, ...), so each counterpart is found at once.
This package imports torch, numpy, pandas and scipy only — never jax or
the JAX package.

Models are small frozen dataclasses holding raw (softplus-inverse)
parameter tensors with a leading batch axis; `params.tree_leaves` lists
them in the JAX package's `jax.tree.leaves` order. Entry points take
`device` and `dtype`, default to ``"cuda"`` and float32 (the JAX package
runs float32 on the TPU, where x64 is off) and raise on a machine without
a GPU instead of dropping to the CPU. Tests pass ``device="cpu"``.

Kernels: `ops/stationary_nll.py`, `ops/blocked_nll.py`, `ops/nll.py` and
`ops/svgp_gram.py` launch the hand-written CUDA kernels in
`csrc/stationary_nll.cu` (the fused NLL tiers), `csrc/dense_nll.cu` (the
dense tier's factor), `csrc/blocked_panel.cu` (the blocked tier's panel
factor), `csrc/trinv.cu` (the hinv tier's diagonal-block inverse) and
`csrc/svgp_gram.cu` (the SVGP ELBO's batch phase), built with nvcc
at first use into `build/`, for CUDA tensors, and their plain PyTorch
versions for CPU tensors.
"""

from portfoliooptgp_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
