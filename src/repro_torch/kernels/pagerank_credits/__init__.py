"""PageRank's credit sum by destination bins (CUDA)."""
