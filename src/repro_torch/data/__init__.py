from repro_torch.data.csr import CSRMatrix
from repro_torch.data.pipeline import LMDataPipeline, Prefetcher, partition_rows, shard_batch
from repro_torch.data.synthetic import (
    SyntheticLM,
    kmeans_dataset,
    lm_batch,
    logreg_dataset,
    nmf_dataset,
    powerlaw_graph,
)

__all__ = [
    "CSRMatrix", "LMDataPipeline", "Prefetcher", "partition_rows", "shard_batch",
    "SyntheticLM", "kmeans_dataset", "lm_batch", "logreg_dataset",
    "nmf_dataset", "powerlaw_graph",
]
