"""nmf's initial factors drawn on the card, numpy's normal stream bit for bit (CUDA)."""
