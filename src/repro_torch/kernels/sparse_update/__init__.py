"""Sparse scatter-add (CUDA): the receive side of the accumulator's pairs."""
