"""Deterministic synthetic datasets mirroring the paper's evaluation data.

These are the analytics path's "weights": the generators are plain numpy on
``default_rng(seed)``, the same draws in the same order as
:mod:`repro.data.synthetic`, so both packages make identical data from one
seed.  The LM token streams wait for the LM slice.
"""

from __future__ import annotations

import numpy as np


def logreg_dataset(n_rows: int, n_features: int, seed: int = 0, noise: float = 0.1):
    """Linearly-separable-ish binary data with a known ground-truth theta."""
    rng = np.random.default_rng(seed)
    theta_true = rng.normal(size=(n_features,)).astype(np.float32)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    logits = x @ theta_true + noise * rng.normal(size=(n_rows,)).astype(np.float32)
    y = (1 / (1 + np.exp(-logits)) > 0.5).astype(np.float32)
    return x, y, theta_true


def kmeans_dataset(n_rows: int, n_features: int, k: int, seed: int = 0, spread: float = 0.15):
    """Gaussian blobs around k well-separated centers."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(k, n_features)).astype(np.float32)
    assign = rng.integers(0, k, size=(n_rows,))
    x = centers[assign] + spread * rng.normal(size=(n_rows, n_features)).astype(np.float32)
    return x.astype(np.float32), centers, assign


def powerlaw_graph(n_vertices: int, avg_degree: int = 8, seed: int = 0):
    """Preferential-attachment-flavoured directed edge list (src, dst)."""
    rng = np.random.default_rng(seed)
    n_edges = n_vertices * avg_degree
    # Zipf-ish destination popularity, uniform sources — cheap power-law proxy.
    dst_pop = rng.zipf(1.6, size=n_edges) % n_vertices
    src = rng.integers(0, n_vertices, size=n_edges)
    edges = np.stack([src, dst_pop], axis=1).astype(np.int32)
    return edges
