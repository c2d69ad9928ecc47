"""Optimizers (L-BFGS with a zoom line search, batched L-BFGS, Adam), the
menu trainer, the SVGP trainers and natural-gradient steps."""
