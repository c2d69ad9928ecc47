"""Optimizers (L-BFGS with a zoom line search, batched L-BFGS) and the
menu trainer."""
