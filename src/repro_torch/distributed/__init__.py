"""The distributed layer — port of the reference's ``distributed/``:
sharding rules as DTensor placements (``sharding``), the constraint
context (``context``), int8 gradient compression (``compression``), the
GPipe pipeline (``pipeline``) and the kernels on DTensor shards
(``shards``)."""
from repro_torch.distributed.context import constrain, sharding_rules

__all__ = ["constrain", "sharding_rules"]
