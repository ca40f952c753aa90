"""The fused sparsify→scatter-add reduce (CUDA)."""
