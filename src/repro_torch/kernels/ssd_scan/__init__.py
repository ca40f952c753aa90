"""Mamba2 SSD scan (CUDA): chunks in parallel on the tensor cores, the state
passed from chunk to chunk through device scratch."""
