"""The paper's analytics apps on the port's host Session (nmf waits: it has
no kernel and is not on this slice's path)."""

from repro_torch.analytics import kmeans, logreg, pagerank

__all__ = ["kmeans", "logreg", "pagerank"]
