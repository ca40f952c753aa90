"""The accumulator's reduces (CUDA): the dense round's row fold
(``accumulate_blocked``) and the fused sparsify→scatter-add."""
