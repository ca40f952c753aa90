"""nmf's two products over R, R·Qᵀ and Pᵀ·R, in 3xTF32 on the tensor cores (CUDA)."""
