"""Serving entry points of the port (training and cell assembly come later)."""
