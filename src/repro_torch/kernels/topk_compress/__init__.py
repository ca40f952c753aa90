"""Blocked top-k compression (CUDA argmax and bitonic bodies)."""
