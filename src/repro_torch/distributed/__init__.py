"""The distributed layer: logical-axis sharding rules and the query
layer's shard layouts (``sharding``), context-parallel decode
(``context_parallel``), the GPipe pipeline (``pipeline``) and int8
gradient compression (``compression``), on ``torch.distributed``."""
from repro_torch.distributed import (  # noqa: F401
    compression, context_parallel, pipeline, sharding,
)
