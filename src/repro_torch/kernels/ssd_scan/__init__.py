"""Mamba2 SSD scan (CUDA): chunks in order, the state resident on chip."""
