"""Launch layer of the port: the step functions, the serving loop and the
trainer (meshes, sharding rules, dry-run and roofline are not ported)."""

from repro_torch.launch.train import train

__all__ = ["train"]
