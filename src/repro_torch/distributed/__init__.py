"""Sharding for the query layer (``sharding.py``): shard layouts, the
hash that owns a key, and the shuffle that partitions rows into
per-shard buckets."""
from repro_torch.distributed import sharding  # noqa: F401
