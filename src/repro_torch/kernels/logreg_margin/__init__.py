"""Logistic regression's margins and residuals over a CSR design matrix (CUDA)."""
