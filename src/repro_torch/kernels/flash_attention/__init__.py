"""Flash attention (CUDA): online softmax over KV tiles, GQA layout in place."""
