"""The paper's four analytics apps (logreg / kmeans / nmf / pagerank) on the
port's host Session."""

from repro_torch.analytics import kmeans, logreg, nmf, pagerank

__all__ = ["kmeans", "logreg", "nmf", "pagerank"]
