"""Training steps over the data axis (the one-device part of the JAX package's
parallel/)."""
