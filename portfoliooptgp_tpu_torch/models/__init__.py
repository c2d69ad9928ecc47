"""Models of the ported paths: exact GPR, ARIMA, the ICM multi-output GP,
the sparse and variational models (SVGP, SGPR, VGP) and their likelihoods."""
