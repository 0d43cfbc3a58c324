"""Parallelism: the packed cell axis over processes, multi-process launch."""

from .launch import host_shard_bounds, initialize_distributed
from .sharding import CellSharding

__all__ = ["CellSharding", "host_shard_bounds", "initialize_distributed"]
