from repro_torch.data.pipeline import partition_rows
from repro_torch.data.synthetic import kmeans_dataset, logreg_dataset, powerlaw_graph

__all__ = ["kmeans_dataset", "logreg_dataset", "partition_rows", "powerlaw_graph"]
