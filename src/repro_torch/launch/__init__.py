"""Launch layer of the port: meshes, sharding rules, step builders and
cells, the roofline, the serving loop and the trainer.

Importing this package imports no dry run: ``repro_torch.launch.dryrun``
runs as its own process (``python -m repro_torch.launch.dryrun``), as
``repro``'s does.
"""

from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    ICI_LINK_BW,
    PEAK_FLOPS_BF16,
    data_axes,
    dp_degree,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.train import train

__all__ = [
    "HBM_BW", "HBM_BYTES", "ICI_LINK_BW", "PEAK_FLOPS_BF16",
    "data_axes", "dp_degree", "make_host_mesh", "make_production_mesh",
    "train",
]
