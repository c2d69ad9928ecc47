"""Models of the ported paths: exact GPR, its Gaussian likelihood, ARIMA and
the ICM multi-output GP."""
