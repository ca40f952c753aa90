"""K-means assignment (CUDA)."""
