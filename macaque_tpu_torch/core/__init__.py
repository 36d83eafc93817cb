"""core of the PyTorch port: the config tree, the device mesh, tracing."""

from macaque_tpu_torch.core.mesh import make_mesh, replicate, shard_over

__all__ = ["make_mesh", "shard_over", "replicate"]
