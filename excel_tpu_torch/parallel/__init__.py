"""Data-parallel runs on torch.distributed: one process a device, the
process group in place of the JAX package's mesh."""
from .distributed import initialize, is_primary
from .mesh import pad_to_multiple, replicate, shard_local_batch

__all__ = ["initialize", "is_primary", "pad_to_multiple", "replicate",
           "shard_local_batch"]
