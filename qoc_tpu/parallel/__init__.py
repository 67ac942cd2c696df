from . import batch, mesh, shard
